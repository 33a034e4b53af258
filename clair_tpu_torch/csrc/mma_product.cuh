// The layer-independent parts of the port's two BiLSTM backwards (the
// streaming backward, bilstm_stream_bwd.cu, and the resident training
// backward, bilstm_train.cu), for Hopper (sm_90a):
// - float32 operands as three bf16 pieces in device memory (split_pieces);
// - one templated tensor-core product (mma_product) that each backward
//   instantiates with its problems: the gate pre-activations, the weight
//   sums dW, dU, db and dx;
// - the reverse sweep with the carry dh_carry = dgates . U^T in float32 FMA
//   (bilstm_bwd_sweep_fma), templated on a layout policy that maps
//   (direction, row, step) to addresses, so one kernel body serves both
//   backwards' layouts.
//
// A product problem P supplies:
//   kAK, kBKMajor  whether A ([m][k]) and B ([n][k]) are K-major, else their
//                  rows run along the reduction ([k][m], [k][n]);
//   kPA, kPB       the bf16 pieces of each operand; the product sums the
//                  piece pairs (i, j) with i + j < max(kPA, kPB);
//   kDb            whether the block row at m = 0 also sums B's columns over
//                  the reduction (db beside dW and dU);
//   a(m, k, ps), bm(n, k, ps)  piece 0 of the 16-byte chunk of A at (m, k)
//                  and of B at (n, k) in global indices (B's indices as its
//                  layout has them), null past the edges; piece p is `ps` * p
//                  elements further;
//   k_begin(), k_end(), m_extent(), n_extent(), base() (a device address for
//                  the zero-filled chunks), store(m, n, v0, v1) for outputs n
//                  and n + 1, store_db(n, v).
//
// Numerics: mma.sync m16n8k16 with bf16 operands and float32 sums, no TF32.
// A float32 operand v goes as bf16 pieces, each the rounding of what the
// earlier ones leave: p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1);
// with three pieces |v - p0 - p1 - p2| <= 2^-24 |v|, and the pairs i + j >= 3
// that the product drops are below 2^-24 of it: float32-level products in
// six passes.
//
// The sweep's layout policy S supplies the fields gates (float32
// pre-activations, a row of 4H per (direction, row, step)), pieces (the
// dgates out, n_pieces bf16 rows of 4H per entry), c_out (float32), dh_out
// (in T), ut (U^T, (2, 4H, H) in T), batch (rows per direction), t_len and
// hidden, and
//   time(dir, step)  the step's time index;
//   row(dir, r, t)   the entry's row in gates and pieces;
//   cell(dir, r, t)  the offset of unit 0 of the entry in c_out and dh_out;
//   prev(dir, t)     the time index of c_prev, or -1 at the sequence edge
//                    (the zero initial state).
#pragma once

#include "lstm_cell.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 227 * 1024;

// An operand's rows as bf16 pieces: piece p of row r starts at
// base + (r * pieces + p) * stride elements (bf16 mode's x, h, W and U are
// one piece, the tensors themselves). at() gives piece 0; piece p is
// `stride` * p elements further.
struct Pieces {
    const bf16* base;
    int stride, pieces;
    __device__ const bf16* at(size_t row, int col, int& piece_stride) const {
        piece_stride = stride;
        return base + row * pieces * static_cast<size_t>(stride) + col;
    }
};

// ---- float32 operands as three bf16 pieces --------------------------------

// dst (rows, 3, cols) from src (rows, cols): p0 = bf16(v), p1 = bf16(v - p0),
// p2 = bf16(v - p0 - p1), each the rounding of what the earlier ones leave.
__global__ void split_pieces(const float* __restrict__ src, bf16* __restrict__ dst, size_t n,
                             int cols) {
    for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < n;
         i += static_cast<size_t>(gridDim.x) * blockDim.x) {
        const size_t r = i / cols;
        const int c = static_cast<int>(i - r * cols);
        float rest = src[i];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const bf16 piece = __float2bfloat16_rn(rest);
            dst[(r * 3 + p) * cols + c] = piece;
            rest -= __bfloat162float(piece);
        }
    }
}

cudaError_t launch_split(const void* src, bf16* dst, size_t rows, int cols, cudaStream_t stream) {
    const size_t n = rows * cols;
    const size_t blocks = (n + kThreads - 1) / kThreads;
    split_pieces<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096), kThreads, 0, stream>>>(
        static_cast<const float*>(src), dst, n, cols);
    return cudaGetLastError();
}

// ---- the tensor-core product ----------------------------------------------

constexpr int kBM = 128, kBN = 128, kBK = 32;
constexpr int kStages = 3;                                // cp.async ring of stages
constexpr int kWarpsN = 4;                                // 2 x 4 warps
constexpr int kWM = 64, kWN = 32;                         // a warp's tile
constexpr int kMT = kWM / 16, kNT = kWN / 8;              // its m16 and n8 tiles

// One piece of an operand's tile in shared memory, bf16. K-major: rows run
// along the output index (m or n), columns along the reduction; otherwise
// rows run along the reduction. Rows are padded by 16 bytes (ldmatrix
// without bank conflicts).
template <bool KMajor, int Extent>
struct Tile {
    static constexpr int kRows = KMajor ? Extent : kBK;
    static constexpr int kCols = KMajor ? kBK : Extent;
    static constexpr int kPitch = kCols + 8;
    static constexpr int kElems = kRows * kPitch;
};

template <class P>
struct ProductLayout {
    using LA = Tile<P::kAK, kBM>;
    using LB = Tile<P::kBKMajor, kBN>;
    static constexpr int kStageA = P::kPA * LA::kElems;  // one stage of A's pieces
    static constexpr int kStageB = P::kPB * LB::kElems;
    static constexpr size_t kBytes = kStages * sizeof(bf16) * (kStageA + kStageB);
    // bf16 mode (at most three pieces in all) fits two blocks an SM
    static constexpr int kMinBlocks = P::kPA + P::kPB <= 3 ? 2 : 1;
};

// Start the cp.async of one stage of an operand's pieces: rows x columns of
// 16-byte chunks, piece 0 of each from chunk(tile row, tile column, stride)
// in global indices and piece p `stride` * p elements further, zeroed where
// it is null or past the reduction's end.
template <class L, bool KMajor, int NPieces, class Chunk>
__device__ __forceinline__ void load_stage(bf16* dst, Chunk chunk, int out0, int k0, int k_end,
                                           const void* any) {
    constexpr int row_chunks = L::kCols / 8;
    for (int i = threadIdx.x; i < L::kRows * row_chunks; i += kThreads) {
        const int r = i / row_chunks, c = (i - r * row_chunks) * 8;
        const int row = KMajor ? out0 + r : k0 + r;
        const int col = KMajor ? k0 + c : out0 + c;
        const int red = KMajor ? col : row;
        int stride = 0;
        const bf16* src = red < k_end ? chunk(row, col, stride) : nullptr;
#pragma unroll
        for (int p = 0; p < NPieces; ++p)
            cp_async16_or_zero(dst + p * L::kElems + r * L::kPitch + c,
                               src != nullptr ? src + p * stride : nullptr, any);
    }
}

// The A fragments of this warp's four m16 tiles at depth kk of a bf16 tile
// (pitch P): K-major [m][k] by ldmatrix, else [k][m] by ldmatrix.trans.
template <bool KMajor, int P>
__device__ __forceinline__ void a_fragments(const bf16* tile, int wm, int kk, unsigned (&f)[kMT][4]) {
    const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) {
        const int m = wm + mt * 16;
        if constexpr (KMajor)
            ldmatrix_x4(f[mt], tile + (m + r + (q & 1) * 8) * P + kk + (q >> 1) * 8);
        else
            ldmatrix_x4_trans(f[mt], tile + (kk + r + (q >> 1) * 8) * P + m + (q & 1) * 8);
    }
}

// The B fragments of this warp's four n8 tiles, two per ldmatrix: K-major
// [n][k], else [k][n] transposed.
template <bool KMajor, int P>
__device__ __forceinline__ void b_fragments(const bf16* tile, int wn, int kk, unsigned (&f)[kNT][2]) {
    const int lane = threadIdx.x & 31, q = lane >> 3, r = lane & 7;
#pragma unroll
    for (int nt = 0; nt < kNT; nt += 2) {
        const int n = wn + nt * 8;
        unsigned v[4];
        if constexpr (KMajor)
            ldmatrix_x4(v, tile + (n + (q >> 1) * 8 + r) * P + kk + (q & 1) * 8);
        else
            ldmatrix_x4_trans(v, tile + (kk + (q & 1) * 8 + r) * P + n + (q >> 1) * 8);
        f[nt][0] = v[0];
        f[nt][1] = v[1];
        f[nt + 1][0] = v[2];
        f[nt + 1][1] = v[3];
    }
}

// 128 x 128 output tiles, 8 warps of 64 x 32, depth 32 a stage, every
// operand's bf16 pieces staged by cp.async (zero-filled past every edge)
// into a ring of three buffers, two in flight while one is multiplied,
// fragments by ldmatrix (.trans where the operand's rows run along the
// reduction). grid = (ceil(n_extent / kBN), ceil(m_extent / kBM), problem's
// z), kThreads.
template <class P>
__global__ void __launch_bounds__(kThreads, ProductLayout<P>::kMinBlocks) mma_product(const P p) {
    using S = ProductLayout<P>;
    using LA = typename S::LA;
    using LB = typename S::LB;
    // (named apart from the including file's kernels, whose dynamic shared
    // memory may have another type)
    extern __shared__ __align__(16) unsigned char product_smem[];
    bf16* a_stages = reinterpret_cast<bf16*>(product_smem);
    bf16* b_stages = a_stages + kStages * S::kStageA;

    const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
    const int k_begin = p.k_begin(), k_end = p.k_end();
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int wm = (warp / kWarpsN) * kWM, wn = (warp % kWarpsN) * kWN;
    const bool sums_db = P::kDb && blockIdx.y == 0 && threadIdx.x < kBN;
    auto a_chunk = [&](int row, int col, int& stride) { return p.a(row, col, stride); };
    auto b_chunk = [&](int row, int col, int& stride) { return p.bm(row, col, stride); };
    const void* any = p.base();  // a device address for the zero-filled chunks
    constexpr int kPasses = P::kPA > P::kPB ? P::kPA : P::kPB;  // piece pairs i + j below this

    float acc[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;
    float db = 0.0f;

    // a ring of kStages buffers: stage s + kStages - 1 is loading while s is
    // multiplied; one (possibly empty) commit group a stage
    auto stage = [&](int s) {
        const int buf = s % kStages, k0 = k_begin + s * kBK;
        if (k0 < k_end) {
            load_stage<LA, P::kAK, P::kPA>(a_stages + buf * S::kStageA, a_chunk, m0, k0, k_end, any);
            load_stage<LB, P::kBKMajor, P::kPB>(b_stages + buf * S::kStageB, b_chunk, n0, k0, k_end, any);
        }
        cp_async_commit();
    };

    const int n_stages = k_begin < k_end ? (k_end - k_begin + kBK - 1) / kBK : 0;
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) stage(s);
    for (int s = 0; s < n_stages; ++s) {
        cp_async_wait<kStages - 2>();  // stage s has landed for this thread
        __syncthreads();  // ... for every thread, and every read of stage s - 1 is done
        stage(s + kStages - 1);        // into the buffer of stage s - 1
        const int buf = s % kStages;
        const bf16* a_s = a_stages + buf * S::kStageA;
        const bf16* b_s = b_stages + buf * S::kStageB;
        if constexpr (P::kDb) {
            // B is [m][g] here: column threadIdx.x's sum over the stage, its
            // pieces added first
            if (sums_db) {
                for (int r = 0; r < kBK; ++r) {
                    float v = 0.0f;
#pragma unroll
                    for (int q = 0; q < P::kPB; ++q)
                        v += __bfloat162float(b_s[q * LB::kElems + r * LB::kPitch + threadIdx.x]);
                    db += v;
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            unsigned bfr[P::kPB][kNT][2];
#pragma unroll
            for (int j = 0; j < P::kPB; ++j)
                b_fragments<P::kBKMajor, LB::kPitch>(b_s + j * LB::kElems, wn, kk, bfr[j]);
#pragma unroll
            for (int i = 0; i < P::kPA; ++i) {
                unsigned af[kMT][4];
                a_fragments<P::kAK, LA::kPitch>(a_s + i * LA::kElems, wm, kk, af);
#pragma unroll
                for (int j = 0; j < P::kPB; ++j) {
                    if (i + j >= kPasses) continue;  // the pairs below 2^-24 of the product
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                        for (int nt = 0; nt < kNT; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[j][nt]);
                }
            }
        }
    }
    cp_async_wait<0>();  // no copy outlives the block

    const int gid = lane >> 2, tq = lane & 3;
    const int m_extent = p.m_extent(), n_extent = p.n_extent();
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
            const int n = n0 + wn + nt * 8 + 2 * tq;
            if (n >= n_extent) continue;  // n_extent is even: n + 1 is real too
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                const int m = m0 + wm + mt * 16 + gid + h * 8;
                if (m < m_extent) p.store(m, n, acc[mt][nt][2 * h], acc[mt][nt][2 * h + 1]);
            }
        }
    if (sums_db && n0 + static_cast<int>(threadIdx.x) < n_extent) p.store_db(n0 + threadIdx.x, db);
}

template <class P>
cudaError_t launch_product(const P& p, int n_extent, int m_extent, int z, cudaStream_t stream) {
    constexpr size_t smem = ProductLayout<P>::kBytes;
    static_assert(smem <= kSmemLimit, "product tiles exceed shared memory");
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_dynamic_smem(mma_product<P>, smem);
        if (err != cudaSuccess) return err;
    }
    const dim3 grid((n_extent + kBN - 1) / kBN, (m_extent + kBM - 1) / kBM, z);
    mma_product<P><<<grid, kThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

// ---- the reverse sweep's cell and the float32 FMA sweep -------------------

// One (row, unit)'s step: its gates, c_t, c_prev and dh_out.
struct Cell {
    float a[4], c, c_prev, dh_out;
};

// The values of (row, t, unit j) into v; with_c false takes c_t from
// v.c_prev, the last step's c_prev (the sweep walks t one step at a time).
template <typename T, class S>
__device__ __forceinline__ void load_cell(const S& s, int dir, int row, int t, int j, Cell& v,
                                          bool with_c) {
    const float c_t = v.c_prev;
    v = Cell{};
    if (row >= s.batch) return;
    const int hidden = s.hidden, gates = 4 * hidden;
    const float* g = s.gates + s.row(dir, row, t) * gates + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.a[q] = g[q * hidden];
    const size_t at = s.cell(dir, row, t) + j;
    v.c = with_c ? s.c_out[at] : c_t;
    v.dh_out = to_float(static_cast<const T*>(s.dh_out)[at]);
    const int tp = s.prev(dir, t);
    if (tp >= 0) v.c_prev = s.c_out[s.cell(dir, row, tp) + j];
}

// The cell's backward (pallas_bilstm_stream.py:110-136,
// pallas_bilstm_train.py:108-125): dgates of the step from its gate
// pre-activations a, c_t, c_prev and dh = dh_out + dh_carry; dc carries to
// the previous step. The gate functions of the forward's dtype
// (gate_sigmoid, gate_tanh).
template <typename T>
__device__ __forceinline__ void cell_backward(const float (&a)[4], float c, float c_prev,
                                              float dh, float& dc, float (&dg)[4]) {
    const float i_g = gate_sigmoid<T>(a[0]);
    const float f_g = gate_sigmoid<T>(a[1]);
    const float g_g = gate_tanh<T>(a[2]);
    const float o_g = gate_sigmoid<T>(a[3]);
    const float tanh_c = gate_tanh<T>(c);
    const float dcv = dc + dh * o_g * (1.0f - tanh_c * tanh_c);
    dg[0] = dcv * g_g * i_g * (1.0f - i_g);
    dg[1] = dcv * c_prev * f_g * (1.0f - f_g);
    dg[2] = dcv * i_g * (1.0f - g_g * g_g);
    dg[3] = dh * tanh_c * o_g * (1.0f - o_g);
    dc = dcv * f_g;
}

// The dgates of (row, t, unit j) as the sweep's bf16 pieces.
template <class S>
__device__ __forceinline__ void store_pieces(const S& s, int dir, int row, int t, int j,
                                             const float (&dg)[4]) {
    const int gates = 4 * s.hidden;
    bf16* out = s.pieces + s.row(dir, row, t) * s.n_pieces * gates + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        float rest = dg[g];
        for (int p = 0; p < s.n_pieces; ++p) {
            const bf16 piece = __float2bfloat16_rn(rest);
            out[p * gates + g * s.hidden] = piece;
            rest -= __bfloat162float(piece);
        }
    }
}

// The sweep with the carry in float32 FMA. blockDim.x == H, a thread owning
// one unit of every row; gridDim = (ceil(batch / R), 2), blockIdx.y the
// direction. U^T streams through shared memory in chunks of
// `FmaLayout::chunk` rows (cp.async, two buffers), read by every row of the
// block. A step reads its R rows' gates before any thread writes their
// pieces (where the pieces overwrite the gates in place). (Loading the next
// step's gates during the carry, as the streaming backward's tensor-core
// sweep does, ran 8-10% slower here on an H100.)
template <typename T, int R>
struct FmaLayout {
    int chunk;  // rows of U^T a stage: 32, fewer where 32 rows pass 32 KB
    size_t ut_off, total;
    __host__ __device__ explicit FmaLayout(int hidden) {
        chunk = 32;
        while (chunk > 4 && static_cast<size_t>(chunk) * hidden * sizeof(T) > 32 * 1024) chunk /= 2;
        ut_off = sizeof(float) * R * 5 * static_cast<size_t>(hidden);  // dh_s (R, H), dg_s (R, 4H)
        total = ut_off + 2 * static_cast<size_t>(chunk) * hidden * sizeof(T);
    }
};

template <typename T, int R, class S>
__global__ void bilstm_bwd_sweep_fma(const S s) {
    // (named apart from the including file's kernels, whose dynamic shared
    // memory may have another type)
    extern __shared__ __align__(16) unsigned char sweep_smem[];
    const int hidden = blockDim.x, gates = 4 * hidden;
    const FmaLayout<T, R> L(hidden);
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * R;
    float* dh_s = reinterpret_cast<float*>(sweep_smem);  // (R, H): dh_carry
    float* dg_s = dh_s + R * hidden;               // (R, 4H): this step's dgates
    T* ut_s = reinterpret_cast<T*>(sweep_smem + L.ut_off);  // 2 x (chunk, H) of U^T
    const T* utd = static_cast<const T*>(s.ut) + static_cast<size_t>(dir) * gates * hidden;
    constexpr int per = 16 / sizeof(T);
    const int chunk_copies = L.chunk * hidden / per;
    auto stage_ut = [&](int c, int buf) {
        const T* src = utd + static_cast<size_t>(c) * L.chunk * hidden;
        T* dst = ut_s + static_cast<size_t>(buf) * L.chunk * hidden;
        for (int i = j; i < chunk_copies; i += hidden) cp_async16(dst + i * per, src + i * per);
        cp_async_commit();
    };

    float dc[R];
    Cell cell[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        dc[r] = 0.0f;
        dh_s[r * hidden + j] = 0.0f;
        cell[r].c_prev = 0.0f;
    }
    for (int step = 0; step < s.t_len; ++step) {
        const int t = s.time(dir, step);
        stage_ut(0, 0);  // the carry's first chunk, in flight during the cell's backward
#pragma unroll
        for (int r = 0; r < R; ++r) load_cell<T>(s, dir, row0 + r, t, j, cell[r], step == 0);
        __syncthreads();  // every gate of the step is read; dh_s and dg_s are free
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (row0 + r < s.batch) {
                cell_backward<T>(cell[r].a, cell[r].c, cell[r].c_prev,
                                 cell[r].dh_out + dh_s[r * hidden + j], dc[r], dg);
                store_pieces(s, dir, row0 + r, t, j, dg);
            }
#pragma unroll
            for (int g = 0; g < 4; ++g) dg_s[r * gates + g * hidden + j] = dg[g];
        }

        // dh_carry[r][j] = sum_k dgates[r][k] * U[j][k], U^T chunk by chunk
        float carry[R];
#pragma unroll
        for (int r = 0; r < R; ++r) carry[r] = 0.0f;
        const int chunks = gates / L.chunk;
        for (int c = 0; c < chunks; ++c) {
            if (c + 1 < chunks) {
                stage_ut(c + 1, (c + 1) & 1);
                cp_async_wait<1>();
            } else {
                cp_async_wait<0>();
            }
            __syncthreads();  // chunk c (and at c = 0 dg_s) complete
            const T* us = ut_s + static_cast<size_t>(c & 1) * L.chunk * hidden + j;
            const float* dgk = dg_s + c * L.chunk;
            for (int k = 0; k < L.chunk; k += 4) {
                const float u0 = to_float(us[k * hidden]), u1 = to_float(us[(k + 1) * hidden]);
                const float u2 = to_float(us[(k + 2) * hidden]), u3 = to_float(us[(k + 3) * hidden]);
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    const float4 d = *reinterpret_cast<const float4*>(dgk + r * gates + k);
                    carry[r] = fmaf(d.w, u3, fmaf(d.z, u2, fmaf(d.y, u1, fmaf(d.x, u0, carry[r]))));
                }
            }
            __syncthreads();  // every read of this chunk's buffer is done
        }
#pragma unroll
        for (int r = 0; r < R; ++r) dh_s[r * hidden + j] = carry[r];
    }
}

template <typename T, int R, class S>
cudaError_t launch_sweep_fma(const S& s, cudaStream_t stream) {
    const size_t smem = FmaLayout<T, R>(s.hidden).total;
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    const cudaError_t err = allow_dynamic_smem(bilstm_bwd_sweep_fma<T, R, S>, smem);
    if (err != cudaSuccess) return err;
    bilstm_bwd_sweep_fma<T, R, S><<<dim3((s.batch + R - 1) / R, 2), dim3(s.hidden), smem, stream>>>(s);
    return cudaGetLastError();
}

// The FMA sweep's rows a block: 4, or 8 from B = 4096 (on an H100 at
// B = 10,000, 8 ran 14-19% faster than 4, and 16 rows slower than both).
inline int fma_sweep_rows(int batch) { return batch >= 4096 ? 8 : 4; }

}  // namespace
