// The layer-independent parts of the port's two BiLSTM backwards (the
// streaming backward, bilstm_stream_bwd.cu, and the resident training
// backward, bilstm_train.cu), for Hopper (sm_90a):
// - float32 operands as three bf16 pieces in device memory (split_pieces);
// - one templated tensor-core product (mma_product) that each backward
//   instantiates with its float32 problems: the gate pre-activations, the
//   weight sums dW, dU, db and dx (the streaming backward's bf16 mode runs
//   its products on wgmma fed by TMA, wgmma_product.cuh); the float32
//   forwards' x.W take it too;
// - the cell's backward that every reverse sweep runs (cell_backward): the
//   float32 sweep on a thread-block cluster (lstm_bwd_sweep.cuh) and row 2's
//   two bf16 sweeps (bilstm_stream_bwd.cu).
//
// A product problem P supplies:
//   kAK, kBKMajor  whether A ([m][k]) and B ([n][k]) are K-major, else their
//                  rows run along the reduction ([k][m], [k][n]);
//   kDb            whether the block row at m = 0 also sums B's columns over
//                  the reduction (db beside dW and dU) in float32 on the
//                  CUDA cores, each row's pieces added first;
//   a(m, k, ps), bm(n, k, ps)  piece 0 of the 16-byte chunk of A at (m, k)
//                  and of B at (n, k) in global indices (B's indices as its
//                  layout has them), null past the edges; piece p is `ps` * p
//                  elements further;
//   k_begin(), k_end(), m_extent(), n_extent(), base() (a device address for
//                  the zero-filled chunks), store(m, n, v0, v1) for outputs n
//                  and n + 1, store_db(n, v).
//
// Numerics: mma.sync m16n8k16 with bf16 operands and float32 sums, no TF32.
// Every operand is float32 as kPieces = 3 bf16 pieces, each the rounding of
// what the earlier ones leave: p0 = bf16(v), p1 = bf16(v - p0),
// p2 = bf16(v - p0 - p1); |v - p0 - p1 - p2| <= 2^-24 |v|, and the piece
// pairs i + j >= 3 that the product drops are below 2^-24 of it:
// float32-level products in six passes. The pair (0, 0) sums in one float32
// accumulator and the five smaller pairs in another, added once per tile:
// the tensor cores' float32 accumulate cuts toward zero, and one
// accumulator over every pass (96 mma steps at K = 256, 80 of them small
// pairs) drifted from float64 by up to 2e-5 (PERF.md, Findings).
#pragma once

#include "lstm_cell.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr size_t kSmemLimit = 227 * 1024;
constexpr int kPieces = 3;  // bf16 pieces of a float32 operand

// An operand's rows as bf16 pieces: piece p of row r starts at
// base + (r * kPieces + p) * stride elements. at() gives piece 0; piece p
// is `stride` * p elements further.
struct Pieces {
    const bf16* base;
    int stride;
    __device__ const bf16* at(size_t row, int col, int& piece_stride) const {
        piece_stride = stride;
        return base + row * kPieces * static_cast<size_t>(stride) + col;
    }
};

// Row m = t * batch + r of a product over T*B rows: t, and r through `r`,
// with t = m / batch by a float product with inv_b = 1 / batch, corrected
// (exact below 2^24 rows).
__device__ __forceinline__ int split_row(int m, int batch, float inv_b, int& r) {
    int t = __float2int_rd(__int2float_rn(m) * inv_b);
    r = m - t * batch;
    if (r < 0) {
        --t;
        r += batch;
    } else if (r >= batch) {
        ++t;
        r -= batch;
    }
    return t;
}

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
        for (int p = 0; p < kPieces; ++p) {
            const bf16 piece = __float2bfloat16_rn(rest);
            dst[(r * kPieces + p) * cols + c] = piece;
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
    static constexpr int kStageA = kPieces * LA::kElems;  // one stage of A's pieces
    static constexpr int kStageB = kPieces * LB::kElems;
    static constexpr size_t kBytes = kStages * sizeof(bf16) * (kStageA + kStageB);
};

// Start the cp.async of one stage of an operand's pieces: rows x columns of
// 16-byte chunks, piece 0 of each from chunk(tile row, tile column, stride)
// in global indices and piece p `stride` * p elements further, zeroed where
// it is null or past the reduction's end.
template <class L, bool KMajor, class Chunk>
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
        for (int p = 0; p < kPieces; ++p)
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
__global__ void __launch_bounds__(kThreads, 1) mma_product(const P p) {
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

    // the pair (0, 0)'s sums, and the five smaller pairs' ("Numerics")
    float acc[kMT][kNT][4], low[kMT][kNT][4];
#pragma unroll
    for (int i = 0; i < kMT; ++i)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[i][j][e] = low[i][j][e] = 0.0f;
    float db = 0.0f;

    // a ring of kStages buffers: stage s + kStages - 1 is loading while s is
    // multiplied; one (possibly empty) commit group a stage
    auto stage = [&](int s) {
        const int buf = s % kStages, k0 = k_begin + s * kBK;
        if (k0 < k_end) {
            load_stage<LA, P::kAK>(a_stages + buf * S::kStageA, a_chunk, m0, k0, k_end, any);
            load_stage<LB, P::kBKMajor>(b_stages + buf * S::kStageB, b_chunk, n0, k0, k_end, any);
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
                    for (int q = 0; q < kPieces; ++q)
                        v += __bfloat162float(b_s[q * LB::kElems + r * LB::kPitch + threadIdx.x]);
                    db += v;
                }
            }
        }
#pragma unroll
        for (int kk = 0; kk < kBK; kk += 16) {
            unsigned bfr[kPieces][kNT][2];
#pragma unroll
            for (int j = 0; j < kPieces; ++j)
                b_fragments<P::kBKMajor, LB::kPitch>(b_s + j * LB::kElems, wn, kk, bfr[j]);
#pragma unroll
            for (int i = 0; i < kPieces; ++i) {
                unsigned af[kMT][4];
                a_fragments<P::kAK, LA::kPitch>(a_s + i * LA::kElems, wm, kk, af);
#pragma unroll
                for (int j = 0; j < kPieces; ++j) {
                    if (i + j >= kPieces) continue;  // the pairs below 2^-24 of the product
#pragma unroll
                    for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
                        for (int nt = 0; nt < kNT; ++nt)
                            mma_bf16(i + j == 0 ? acc[mt][nt] : low[mt][nt], af[mt], bfr[j][nt]);
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
                if (m < m_extent)
                    p.store(m, n, acc[mt][nt][2 * h] + low[mt][nt][2 * h],
                            acc[mt][nt][2 * h + 1] + low[mt][nt][2 * h + 1]);
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

// ---- the reverse sweeps' cell ---------------------------------------------

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

}  // namespace
