// Backward of one bidirectional LSTM layer, both directions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm_stream.py:_bwd_kernel
// (reached through _bwd_pallas and _bilstm_bwd). Same math: from the
// forward's saved h_out and c_out, the gate pre-activations
// x_t.W + h_prev.U + b, then a reverse sweep over time that carries dh and
// dc in float32 and forms
//   dgates = [dc*g*i(1-i), dc*c_prev*f(1-f), dc*i(1-g^2), dh*tanh(c)*o(1-o)]
// with dh = dh_out_t + dh_carry, dc = dc_carry + dh*o*(1 - tanh^2 c),
// dh_carry = dgates.U^T and dc_carry = dc*f; from the dgates
// dx = sum over directions of dgates.W^T (in the input type) and the float32
// sums dW = x^T.dgates, dU = h_prev^T.dgates and db = sum of dgates.
//
// Time indexing: the forward kernel keeps the backward direction at its
// original time index (bilstm_stream_fwd.cu), so direction 0 sweeps
// t = T-1 .. 0 with h_prev = h_out[:, t-1, :H], and direction 1 sweeps
// t = 0 .. T-1 with h_prev = h_out[:, t+1, H:]. The missing neighbour at the
// sequence edge is the zero initial state (the TPU kernel masks the same
// fetch, pallas_bilstm_stream.py:97-101).
//
// Four kernels, one launch of the entry point:
// (a) the gate pre-activations of every (row, step) at once: h_prev is the
//     saved h_out, so they depend on nothing the sweep carries. A product
//     [x | h_prev] . [W ; U] + b over the B*T rows per direction, written as
//     float32 into the (2, B, T, 4H) dgates buffer.
// (b) the reverse sweep, which reads a (row, step)'s gates once and writes
//     that entry's dgates as bf16 pieces (below): in bf16 IN PLACE of the
//     row's float32 gates (two pieces take the same bytes), in float32 to
//     scratch. The only serial work left is the cell's elementwise backward
//     and dh_carry = dgates . U^T. One block per (row tile, direction).
//     bf16, H <= 128: the block stages its direction's U (H x 4H, 128 KB at
//     H = 128) once into shared memory and runs the carry on mma.sync, 16 or
//     32 rows a block (every m16 tile full), with the hardware tanh of the
//     forward's bf16 gates; the next step's gates, c and dh_out are loaded
//     while the carry runs. float32, or a larger H: U (256 KB in float32 at
//     H = 128) does not fit one block, so the carry stays float32 FMA, U^T
//     streamed from L2 through shared memory in chunks, 4 or 8 rows a
//     block; it reads 4H * H values a step, not the (F + 2H) * 4H of a
//     recompute.
// (c) the weight sums dW, dU (A^T . dgates, A = [x | h_prev]) and db over
//     fixed row chunks whose float32 partials the caller adds in a fixed
//     order: deterministic, no atomics.
// (d) dx = [dgates_0 | dgates_1] . [W_0 ; W_1]^T, written once in x's type.
// (a), (c) and (d) are one templated tensor-core product (mma_product):
// 128 x 128 output tiles, 8 warps of 64 x 32, depth 32 a stage, every
// operand's bf16 pieces staged by cp.async (zero-filled past every edge)
// into a ring of three buffers, two in flight while one is multiplied,
// fragments by ldmatrix (.trans where the operand's rows run along the
// reduction).
// The operands reach it as bf16 pieces in device memory, so no block
// converts a tile: bf16 mode's x, h_out, W and U are the tensors
// themselves, and float32 mode's are split once by split_pieces into
// scratch before (a).
//
// Numerics: mma.sync m16n8k16 with bf16 operands and float32 sums, no TF32.
// A bf16 operand goes as it is (bf16 mode: x, h_prev, W, U, exactly as the
// TPU kernel's gate recompute takes them). A float32 operand v goes as bf16
// pieces, each the rounding of what the earlier ones leave:
// p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1), and the product
// sums the piece pairs (i, j) with i + j < pieces, in float32:
// - dgates in bf16 mode: 2 pieces against a bf16 operand, 2 passes;
//   |v - p0 - p1| <= 2^-16 |v|, so each product keeps ~16 bits.
// - every float32 operand in float32 mode: 3 pieces each, 6 passes;
//   |v - p0 - p1 - p2| <= 2^-24 |v| and the dropped pairs are below
//   2^-24 of the product: float32-level products. Two pieces (3 passes,
//   ~2^-16) were measured on the CPU emulation (ops/bilstm_stream.py:
//   split_bf16_product) against jax.grad of the TPU kernel: dW missed the
//   elementwise bound rtol 3e-4, atol 3e-5 by 2.8x; three pieces stay
//   below 0.15 of it.
// The float32 sweep's carry is float32 FMA; the bf16 sweep's carry takes
// the 2-piece dgates against bf16 U.
//
// What bounds each kernel (B = 10,000, T = 33, H = 128; PERF.md has the
// measured split):
// - (a), (c), (d): tensor-core operations: 2 * 2 * B*T * (F + H) * 4H for
//   (a) and for (c), 2 * B*T * 8H * F for (d), times the passes; and the
//   float32 dgates buffer (1.35 GB a layer), written by (a), read and
//   written by (b), read by (c) and (d).
// - (b): the serial chain of 33 steps (a step's loads, the elementwise
//   backward, a block barrier, 32 dependent k16 steps of the carry).
// Measured split, ms at B = 10,000 on an H100 80GB HBM3 at 700 W
// (tools/torch_stream_bwd_parts.py, torch.profiler device time):
//   the earlier design (gates recomputed on the serial chain, FMA products):
//     bf16 lstm1 sweep 12.633, sums 7.491; lstm2 sweep 20.271, sums 14.238,
//     dx 5.904 (60.77 both layers); f32 lstm1 sweep 11.434, sums 4.915;
//     lstm2 sweep 18.951, sums 9.186, dx 6.463 (51.26 both layers).
//   this design: bf16 lstm1 gates 0.901, sweep 1.845, sums 1.331;
//     lstm2 gates 1.509, sweep 1.859, sums 1.866, dx 1.284 (10.78 both
//     layers); f32 lstm1 gates 2.264, sweep 5.355, sums 3.182, pieces
//     0.399; lstm2 gates 4.669, sweep 5.381, sums 4.502, dx 3.095, pieces
//     0.707 (29.81 both layers).
// Left for later: float32 U^T held across a thread-block cluster (the f32
// carry on the tensor cores), wgmma and TMA in the products, and one read
// of dgates feeding both dx and the weight sums.

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

// ---- (a), (c), (d): the tensor-core product -------------------------------

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

// A problem supplies its operands' layouts and pieces, the 16-byte chunk of
// piece p of each operand at a (tile row, tile column) in global indices
// (null past its edges), its reduction range and its stores.
struct XH {  // [x | h_prev] of direction dir: row m of B*T, column k of F + H
    Pieces x, h;
    int rows, t_len, feat, hidden;
    float inv_t;  // 1 / t_len: m % t_len by a float product (m < 2^24), corrected
    __device__ int step(int m) const {
        const int t = m - __float2int_rd(__int2float_rn(m) * inv_t) * t_len;
        return t < 0 ? t + t_len : (t >= t_len ? t - t_len : t);
    }
    __device__ const bf16* at(int m, int k, int dir, int& piece_stride) const {
        if (m >= rows || k >= feat + hidden) return nullptr;
        if (k < feat) return x.at(m, k, piece_stride);
        const int t = step(m);
        const int tp = dir == 0 ? t - 1 : t + 1;
        if (tp < 0 || tp >= t_len) return nullptr;
        return h.at(m - t + tp, dir * hidden + (k - feat), piece_stride);
    }
};

// (a) gates[dir][m][g] = [x | h_prev][m] . [W ; U][:, g] + b[g]; grid.z = dir.
template <int PX>
struct GateProblem {
    static constexpr bool kAK = true, kBKMajor = false;  // A [m][k]; B [k][g]
    static constexpr int kPA = PX, kPB = PX;
    static constexpr bool kDb = false;
    XH xh;
    Pieces w, u;
    const float* b;
    float* out;
    int gates;
    __device__ int dir() const { return blockIdx.z; }
    __device__ const void* base() const { return xh.x.base; }
    __device__ int k_begin() const { return 0; }
    __device__ int k_end() const { return xh.feat + xh.hidden; }
    __device__ int m_extent() const { return xh.rows; }
    __device__ int n_extent() const { return gates; }
    __device__ const bf16* a(int m, int k, int& ps) const { return xh.at(m, k, dir(), ps); }
    __device__ const bf16* bm(int k, int g, int& ps) const {
        if (g >= gates) return nullptr;
        if (k < xh.feat) return w.at(dir() * xh.feat + k, g, ps);
        if (k < xh.feat + xh.hidden) return u.at(dir() * xh.hidden + k - xh.feat, g, ps);
        return nullptr;
    }
    __device__ void store(int m, int g, float v0, float v1) const {
        const float* bd = b + dir() * gates;
        *reinterpret_cast<float2*>(out + (static_cast<size_t>(dir()) * xh.rows + m) * gates + g) =
            make_float2(v0 + bd[g], v1 + bd[g + 1]);
    }
    __device__ void store_db(int, float) const {}
};

// (c) partial[split][dir][a][g] = sum over the chunk's rows m of
// A[m][a] * dgates[dir][m][g], and row F + H the chunk's sum of dgates;
// grid.z = split * 2 + dir.
template <int PX, int PD>
struct WeightSumProblem {
    static constexpr bool kAK = false, kBKMajor = false;  // A [m][a]; B [m][g]
    static constexpr int kPA = PX, kPB = PD;
    static constexpr bool kDb = true;
    XH xh;
    Pieces dg;
    float* partial;
    int gates, rows_per_split;
    __device__ int dir() const { return blockIdx.z & 1; }
    __device__ const void* base() const { return dg.base; }
    __device__ int k_begin() const { return (blockIdx.z >> 1) * rows_per_split; }
    __device__ int k_end() const { return min(xh.rows, k_begin() + rows_per_split); }
    __device__ int m_extent() const { return xh.feat + xh.hidden; }
    __device__ int n_extent() const { return gates; }
    __device__ const bf16* a(int m, int k, int& ps) const { return xh.at(m, k, dir(), ps); }
    __device__ const bf16* bm(int m, int g, int& ps) const {
        if (m >= xh.rows || g >= gates) return nullptr;
        return dg.at(static_cast<size_t>(dir()) * xh.rows + m, g, ps);
    }
    __device__ float* slab() const {
        return partial + static_cast<size_t>(blockIdx.z) * (xh.feat + xh.hidden + 1) * gates;
    }
    __device__ void store(int a, int g, float v0, float v1) const {
        *reinterpret_cast<float2*>(slab() + static_cast<size_t>(a) * gates + g) = make_float2(v0, v1);
    }
    __device__ void store_db(int g, float v) const {
        slab()[static_cast<size_t>(xh.feat + xh.hidden) * gates + g] = v;
    }
};

// (d) dx[m][f] = sum over dir, g of dgates[dir][m][g] * W[dir][f][g]; the
// reduction runs over both directions' 4H gates; grid.z = 1.
template <int PX, int PD, typename T>
struct DxProblem {
    static constexpr bool kAK = true, kBKMajor = true;  // A [m][kk]; B [f][kk]
    static constexpr int kPA = PD, kPB = PX;
    static constexpr bool kDb = false;
    Pieces dg, w;
    T* dx;
    int rows, feat, gates;
    __device__ const void* base() const { return dg.base; }
    __device__ int k_begin() const { return 0; }
    __device__ int k_end() const { return 2 * gates; }
    __device__ int m_extent() const { return rows; }
    __device__ int n_extent() const { return feat; }
    __device__ const bf16* a(int m, int kk, int& ps) const {
        if (m >= rows) return nullptr;
        const int d = kk >= gates;
        return dg.at(static_cast<size_t>(d) * rows + m, kk - d * gates, ps);
    }
    __device__ const bf16* bm(int f, int kk, int& ps) const {
        if (f >= feat) return nullptr;
        const int d = kk >= gates;
        return w.at(d * feat + f, kk - d * gates, ps);
    }
    __device__ void store(int m, int f, float v0, float v1) const {
        T* o = dx + static_cast<size_t>(m) * feat + f;
        o[0] = from_float<T>(v0);
        o[1] = from_float<T>(v1);
    }
    __device__ void store_db(int, float) const {}
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

// grid = (ceil(n_extent / kBN), ceil(m_extent / kBM), problem's z), kThreads.
template <class P>
__global__ void __launch_bounds__(kThreads, ProductLayout<P>::kMinBlocks) mma_product(const P p) {
    using S = ProductLayout<P>;
    using LA = typename S::LA;
    using LB = typename S::LB;
    extern __shared__ __align__(16) unsigned char smem[];
    bf16* a_stages = reinterpret_cast<bf16*>(smem);
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

// ---- (b): the reverse sweep ------------------------------------------------

struct SweepArgs {
    const float* gates;   // (2, B*T, 4H) float32 pre-activations
    bf16* pieces;         // dgates out: rows (dir, m) of n_pieces x 4H bf16
    int n_pieces;
    const float* c_out;   // (B, T, 2H) float32
    const void* dh_out;   // (B, T, 2H) in T
    const void* u;        // (2, H, 4H) in T
    const void* ut;       // (2, 4H, H) in T, U transposed (the L2 carry)
    int batch, t_len, hidden;
};

// One (row, unit)'s step: its gates, c_t, c_prev and dh_out.
struct Cell {
    float a[4], c, c_prev, dh_out;
};

// The values of (row, t, unit j) into v; with_c false takes c_t from
// v.c_prev, the last step's c_prev (the sweep walks t one step at a time).
template <typename T>
__device__ __forceinline__ void load_cell(const SweepArgs& s, int dir, int row, int t, int j,
                                          Cell& v, bool with_c) {
    const float c_t = v.c_prev;
    v = Cell{};
    if (row >= s.batch) return;
    const int hidden = s.hidden, gates = 4 * hidden;
    const size_t rows = static_cast<size_t>(s.batch) * s.t_len;
    const size_t m = static_cast<size_t>(row) * s.t_len + t;
    const float* g = s.gates + (dir * rows + m) * gates + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.a[q] = g[q * hidden];
    const size_t at = m * 2 * hidden + dir * hidden + j;
    v.c = with_c ? s.c_out[at] : c_t;
    v.dh_out = to_float(static_cast<const T*>(s.dh_out)[at]);
    const int tp = dir == 0 ? t - 1 : t + 1;
    if (tp >= 0 && tp < s.t_len) v.c_prev = s.c_out[at + (tp - t) * 2 * static_cast<size_t>(hidden)];
}

// The cell's backward (pallas_bilstm_stream.py:110-136): dgates of the
// step from its gate pre-activations a, c_t, c_prev and dh = dh_out +
// dh_carry; dc carries to the previous step. The gate functions of the
// forward's dtype (gate_sigmoid, gate_tanh).
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
__device__ __forceinline__ void store_pieces(const SweepArgs& s, int dir, int row, int t, int j,
                                             const float (&dg)[4]) {
    const int gates = 4 * s.hidden;
    const size_t m = static_cast<size_t>(dir) * s.batch * s.t_len + static_cast<size_t>(row) * s.t_len + t;
    bf16* out = s.pieces + m * s.n_pieces * gates + j;
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

// bf16 sweep, U in shared memory and the carry on the tensor cores; the
// dgates go out as two pieces IN PLACE of the row's float32 gates (the same
// 16H bytes), each row's gates read a step before they are overwritten.
// grid = (ceil(batch / R), 2), kThreads; R rows a block (16 or 32), H <= 128
// and a multiple of 8. Shared memory: U [j][g] (the carry's B operand,
// K-major), the step's dgates as two bf16 pieces [r][g], and dh_carry [r][j].
template <int R>
struct SweepLayout {
    int up, hp;
    size_t pieces_off, dh_off, total;
    __host__ __device__ explicit SweepLayout(int hidden) {
        up = 4 * hidden + 8;
        hp = hidden + 4;
        pieces_off = static_cast<size_t>(hidden) * up * 2;
        dh_off = pieces_off + static_cast<size_t>(2) * R * up * 2;
        total = dh_off + static_cast<size_t>(R) * hp * 4;
    }
};

// Four consecutive units' step in the bf16 sweep: gates, c_t, c_prev,
// dh_out.
struct Cell4 {
    float4 a[4], c, c_prev, dh_out;
};

// The values of (row, t, units j4 .. j4 + 3) into v; with_c false takes c_t
// from v.c_prev, the last step's c_prev (the sweep walks t a step at a
// time).
__device__ __forceinline__ void load_cell4(const SweepArgs& s, int dir, int row, int t, int j4,
                                           Cell4& v, bool with_c) {
    const float4 c_t = v.c_prev;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v.c_prev = zero;
    if (row >= s.batch) {
        v.a[0] = v.a[1] = v.a[2] = v.a[3] = v.c = v.dh_out = zero;
        return;
    }
    const int hidden = s.hidden, gates = 4 * hidden;
    const size_t rows = static_cast<size_t>(s.batch) * s.t_len;
    const size_t m = static_cast<size_t>(row) * s.t_len + t;
    const float* g = s.gates + (dir * rows + m) * gates + j4;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.a[q] = *reinterpret_cast<const float4*>(g + q * hidden);
    const size_t at = m * 2 * hidden + dir * hidden + j4;
    v.c = with_c ? *reinterpret_cast<const float4*>(s.c_out + at) : c_t;
    const uint2 raw = *reinterpret_cast<const uint2*>(static_cast<const bf16*>(s.dh_out) + at);
    const float2 d01 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 d23 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v.dh_out = make_float4(d01.x, d01.y, d23.x, d23.y);
    const int tp = dir == 0 ? t - 1 : t + 1;
    if (tp >= 0 && tp < s.t_len)
        v.c_prev = *reinterpret_cast<const float4*>(
            s.c_out + at + (tp - t) * 2 * static_cast<size_t>(hidden));
}

__device__ __forceinline__ float lane_of(const float4& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// Four bf16 values as one 8-byte store.
__device__ __forceinline__ void store4(bf16* p, const bf16 (&v)[4]) {
    uint2 raw;
    *reinterpret_cast<__nv_bfloat162*>(&raw.x) = __halves2bfloat162(v[0], v[1]);
    *reinterpret_cast<__nv_bfloat162*>(&raw.y) = __halves2bfloat162(v[2], v[3]);
    *reinterpret_cast<uint2*>(p) = raw;
}

template <int R>
__global__ void __launch_bounds__(kThreads, 1) bilstm_bwd_sweep_mma(const SweepArgs s) {
    constexpr int kItems = R * 128 / 4 / kThreads;  // (row, 4 units) a thread, at H = 128
    constexpr int kWarpTiles = 128 / 8 / (kThreads / 32);  // n8 tiles of H a warp, at H = 128
    extern __shared__ __align__(16) unsigned char smem[];
    const int hidden = s.hidden, gates = 4 * hidden, quads = hidden / 4;
    const SweepLayout<R> L(hidden);
    bf16* u_s = reinterpret_cast<bf16*>(smem);
    bf16* dg_s = reinterpret_cast<bf16*>(smem + L.pieces_off);
    float* dh_s = reinterpret_cast<float*>(smem + L.dh_off);
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * R;
    const size_t rows = static_cast<size_t>(s.batch) * s.t_len;

    // this direction's U, once
    const bf16* ud = static_cast<const bf16*>(s.u) + static_cast<size_t>(dir) * hidden * gates;
    const int row_chunks = gates / 8;
    for (int i = threadIdx.x; i < hidden * row_chunks; i += kThreads) {
        const int j = i / row_chunks, c = (i - j * row_chunks) * 8;
        cp_async16(u_s + j * L.up + c, ud + static_cast<size_t>(j) * gates + c);
    }
    cp_async_commit();
    for (int i = threadIdx.x; i < R * L.hp; i += kThreads) dh_s[i] = 0.0f;

    float dc[kItems][4];
    Cell4 cell[kItems];
    const int t_first = dir == 0 ? s.t_len - 1 : 0;
#pragma unroll
    for (int q = 0; q < kItems; ++q) {
#pragma unroll
        for (int u = 0; u < 4; ++u) dc[q][u] = 0.0f;
        const int idx = threadIdx.x + q * kThreads;
        if (idx < R * quads)
            load_cell4(s, dir, row0 + idx / quads, t_first, (idx % quads) * 4, cell[q], true);
    }
    cp_async_wait_all();
    __syncthreads();  // U and the zero dh_carry are in place

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tq = lane & 3;
    const int n_tiles = hidden / 8;
    for (int step = 0; step < s.t_len; ++step) {
        const int t = dir == 0 ? s.t_len - 1 - step : step;
        // the elementwise backward of each (row, 4 units) of the tile
#pragma unroll
        for (int q = 0; q < kItems; ++q) {
            const int idx = threadIdx.x + q * kThreads;
            if (idx >= R * quads) continue;
            const int r = idx / quads, j4 = (idx - r * quads) * 4;
            const int row = row0 + r;
            const float4 carry = *reinterpret_cast<const float4*>(dh_s + r * L.hp + j4);
            bf16 hi[4][4], lo[4][4];  // [gate][unit]
#pragma unroll
            for (int u = 0; u < 4; ++u) {
                const float a[4] = {lane_of(cell[q].a[0], u), lane_of(cell[q].a[1], u),
                                    lane_of(cell[q].a[2], u), lane_of(cell[q].a[3], u)};
                float dg[4];
                cell_backward<bf16>(a, lane_of(cell[q].c, u), lane_of(cell[q].c_prev, u),
                                    lane_of(cell[q].dh_out, u) + lane_of(carry, u), dc[q][u], dg);
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    if (row >= s.batch) dg[g] = 0.0f;
                    hi[g][u] = __float2bfloat16_rn(dg[g]);
                    lo[g][u] = __float2bfloat16_rn(dg[g] - __bfloat162float(hi[g][u]));
                }
            }
#pragma unroll
            for (int g = 0; g < 4; ++g) {
                store4(dg_s + r * L.up + g * hidden + j4, hi[g]);
                store4(dg_s + (R + r) * L.up + g * hidden + j4, lo[g]);
            }
            if (row < s.batch) {
                // the two pieces in place of the row's gates, read last step
                bf16* out = s.pieces + ((dir * rows + static_cast<size_t>(row) * s.t_len + t) * 2) * gates + j4;
#pragma unroll
                for (int g = 0; g < 4; ++g) {
                    store4(out + g * hidden, hi[g]);
                    store4(out + gates + g * hidden, lo[g]);
                }
            }
            // the next step's loads, in flight during the carry
            if (step + 1 < s.t_len)
                load_cell4(s, dir, row, dir == 0 ? t - 1 : t + 1, j4, cell[q], false);
        }
        __syncthreads();  // the step's dgates pieces are complete; dh_s reads done

        // dh_carry[r][j] = sum_g dgates[r][g] * U[j][g]: a warp takes n8
        // tiles warp and warp + 8 of the H units, each piece of each (n, m)
        // tile its own chain of k16 steps, the A fragments shared by both
        if (warp < n_tiles) {
            float acc[kWarpTiles][2][R / 16][4] = {};
            for (int kk = 0; kk < gates; kk += 16) {
                unsigned bv[kWarpTiles][2];
#pragma unroll
                for (int w2 = 0; w2 < kWarpTiles; ++w2)
                    if (warp + w2 * 8 < n_tiles)
                        ldmatrix_x2(bv[w2], u_s + ((warp + w2 * 8) * 8 + (lane & 7)) * L.up + kk
                                                + ((lane >> 3) & 1) * 8);
#pragma unroll
                for (int piece = 0; piece < 2; ++piece)
#pragma unroll
                    for (int mt = 0; mt < R / 16; ++mt) {
                        unsigned av[4];
                        ldmatrix_x4(av, dg_s + (piece * R + mt * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * L.up
                                            + kk + (lane >> 4) * 8);
#pragma unroll
                        for (int w2 = 0; w2 < kWarpTiles; ++w2)
                            if (warp + w2 * 8 < n_tiles) mma_bf16(acc[w2][piece][mt], av, bv[w2]);
                    }
            }
#pragma unroll
            for (int w2 = 0; w2 < kWarpTiles; ++w2) {
                const int nt = warp + w2 * 8;
                if (nt >= n_tiles) continue;
#pragma unroll
                for (int mt = 0; mt < R / 16; ++mt)
#pragma unroll
                    for (int h = 0; h < 2; ++h)
                        *reinterpret_cast<float2*>(dh_s + (mt * 16 + gid + h * 8) * L.hp + nt * 8 + 2 * tq) =
                            make_float2(acc[w2][0][mt][2 * h] + acc[w2][1][mt][2 * h],
                                        acc[w2][0][mt][2 * h + 1] + acc[w2][1][mt][2 * h + 1]);
            }
        }
        __syncthreads();  // dh_carry complete; every read of the pieces done
    }
}

// The sweep with the carry in float32 FMA: float32, and bf16 at hidden
// sizes whose U does not fit one block. blockDim.x == H, a thread owning one
// unit of every row; gridDim = (ceil(batch / R), 2). U^T streams through
// shared memory in chunks of `FmaLayout::chunk` rows (cp.async, two
// buffers), read by every row of the block. A step reads its R rows' gates
// before any thread writes their pieces (in bf16 the pieces overwrite the
// gates in place). (Loading the next step's gates during the carry, as the
// tensor-core sweep does, ran 8-10% slower here on an H100.)
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

template <typename T, int R>
__global__ void bilstm_bwd_sweep_fma(const SweepArgs s) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int hidden = blockDim.x, gates = 4 * hidden;
    const FmaLayout<T, R> L(hidden);
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * R;
    float* dh_s = reinterpret_cast<float*>(smem);  // (R, H): dh_carry
    float* dg_s = dh_s + R * hidden;               // (R, 4H): this step's dgates
    T* ut_s = reinterpret_cast<T*>(smem + L.ut_off);  // 2 x (chunk, H) of U^T
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
        const int t = dir == 0 ? s.t_len - 1 - step : step;
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

// Whether the bf16 sweep holds U in shared memory (H <= 128): decided by the
// shape alone.
template <typename T>
bool sweep_on_tensor_cores(int hidden) {
    return sizeof(T) == 2 && hidden <= 128;
}

template <int R>
cudaError_t launch_sweep_mma(const SweepArgs& s, cudaStream_t stream) {
    const size_t smem = SweepLayout<R>(s.hidden).total;
    const cudaError_t err = allow_dynamic_smem(bilstm_bwd_sweep_mma<R>, smem);
    if (err != cudaSuccess) return err;
    bilstm_bwd_sweep_mma<R><<<dim3((s.batch + R - 1) / R, 2), kThreads, smem, stream>>>(s);
    return cudaGetLastError();
}

template <typename T, int R>
cudaError_t launch_sweep_fma(const SweepArgs& s, cudaStream_t stream) {
    const size_t smem = FmaLayout<T, R>(s.hidden).total;
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    const cudaError_t err = allow_dynamic_smem(bilstm_bwd_sweep_fma<T, R>, smem);
    if (err != cudaSuccess) return err;
    bilstm_bwd_sweep_fma<T, R><<<dim3((s.batch + R - 1) / R, 2), dim3(s.hidden), smem, stream>>>(s);
    return cudaGetLastError();
}

// Rows a sweep block: the tensor-core sweep 16, or 32 from B = 4096 (on an
// H100 at B = 10,000 32 rows ran 7% faster than 16; at B = 512, 16 rows
// 1.1-1.8x faster than 32); the FMA sweep 4, or 8 from B = 4096 (8 ran
// 14-19% faster than 4, and 16 rows slower than both, at B = 10,000).
// `rows` > 0 takes that number where the sweep has it (16 or 32; 4 or 8).
template <typename T>
cudaError_t launch_sweep(const SweepArgs& s, int rows, cudaStream_t stream) {
    if (sweep_on_tensor_cores<T>(s.hidden)) {
        if (rows <= 0) rows = s.batch >= 4096 ? 32 : 16;
        if (rows == 16) return launch_sweep_mma<16>(s, stream);
        if (rows == 32) return launch_sweep_mma<32>(s, stream);
        return cudaErrorInvalidValue;
    }
    if (rows <= 0) rows = s.batch >= 4096 ? 8 : 4;
    if (rows == 4) return launch_sweep_fma<T, 4>(s, stream);
    if (rows == 8) return launch_sweep_fma<T, 8>(s, stream);
    return cudaErrorInvalidValue;
}

// The float32 scratch: the three pieces of x, h_out, W, U and the dgates.
size_t scratch_elems(size_t rows, int feat, int hidden) {
    const size_t gates = 4 * static_cast<size_t>(hidden);
    return 3 * (rows * feat + rows * 2 * hidden + 2 * feat * gates + 2 * hidden * gates +
                2 * rows * gates);
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* u, const void* ut, const void* b,
                   const void* h_out, const void* c_out, const void* dh_out, void* dgates,
                   void* partial, void* dx, void* scratch, long long scratch_bytes, int batch,
                   int t_len, int feat, int hidden, int splits, int rows_per_split,
                   int sweep_rows, cudaStream_t stream) {
    constexpr bool f32 = sizeof(T) == 4;
    constexpr int PX = f32 ? 3 : 1, PD = f32 ? 3 : 2;
    const int rows = batch * t_len;
    const int gates = 4 * hidden;
    float* gate_buf = static_cast<float*>(dgates);
    Pieces xp{static_cast<const bf16*>(x), feat, 1}, hp{static_cast<const bf16*>(h_out), 2 * hidden, 1};
    Pieces wp{static_cast<const bf16*>(w), gates, 1}, up{static_cast<const bf16*>(u), gates, 1};
    // bf16: the dgates' two pieces in place of the gates
    Pieces dgp{static_cast<const bf16*>(dgates), gates, 2};
    cudaError_t err = cudaSuccess;
    if constexpr (f32) {
        if (scratch == nullptr ||
            static_cast<size_t>(scratch_bytes) < sizeof(bf16) * scratch_elems(rows, feat, hidden))
            return cudaErrorInvalidValue;
        bf16* at = static_cast<bf16*>(scratch);
        auto carve = [&](const void* src, size_t n_rows, int cols, Pieces& out) {
            out = Pieces{at, cols, 3};
            if (src != nullptr && err == cudaSuccess) err = launch_split(src, at, n_rows, cols, stream);
            at += 3 * n_rows * cols;
        };
        carve(x, rows, feat, xp);
        carve(h_out, rows, 2 * hidden, hp);
        carve(w, 2 * static_cast<size_t>(feat), gates, wp);
        carve(u, 2 * static_cast<size_t>(hidden), gates, up);
        carve(nullptr, 2 * static_cast<size_t>(rows), gates, dgp);  // written by the sweep
        if (err != cudaSuccess) return err;
    }
    const XH xh{xp, hp, rows, t_len, feat, hidden, 1.0f / t_len};

    GateProblem<PX> gp{xh, wp, up, static_cast<const float*>(b), gate_buf, gates};
    err = launch_product(gp, gates, rows, 2, stream);
    if (err != cudaSuccess) return err;

    const SweepArgs s{gate_buf, const_cast<bf16*>(dgp.base), PD,
                      static_cast<const float*>(c_out), dh_out, u, ut, batch, t_len, hidden};
    err = launch_sweep<T>(s, sweep_rows, stream);
    if (err != cudaSuccess) return err;

    WeightSumProblem<PX, PD> wsp{xh, dgp, static_cast<float*>(partial), gates, rows_per_split};
    err = launch_product(wsp, gates, feat + hidden, splits * 2, stream);
    if (err != cudaSuccess || dx == nullptr) return err;

    DxProblem<PX, PD, T> dp{dgp, wp, static_cast<T*>(dx), rows, feat, gates};
    return launch_product(dp, feat, rows, 1, stream);
}

}  // namespace

// Plain C entry point for ctypes. is_bf16 selects the element type of x, w,
// u, ut, h_out, dh_out and dx (0: float32, 1: bfloat16); b, c_out, dgates
// and partial are float32. dgates (2, B, T, 4H) holds the gates; in bf16
// their rows are then overwritten in place by the dgates' two bf16 pieces.
// scratch (float32 only; may be null for bf16) holds scratch_bytes >=
// 2 * 3 * (B*T*F + B*T*2H + 2F*4H + 2H*4H + 2*B*T*4H) bytes: the bf16
// pieces of x, h_out, W, U and the dgates. partial holds
// splits * 2 * (F + H + 1) * 4H floats, chunk `split` covering rows
// [split * rows_per_split, ...) of the B*T rows; dx may be null (no input
// gradient). F and H must be multiples of 8, and every pointer 16-byte
// aligned. sweep_rows: the sweep's rows a block (0: chosen from the shape;
// 16 or 32 for the bf16 tensor-core sweep, 4 or 8 for the FMA sweep), for
// measuring the choice.
// Launches on `stream`, does not synchronise, and returns the first launch
// error as an int (0: none).
extern "C" int clair_bilstm_stream_bwd(const void* x, const void* w, const void* u,
                                       const void* ut, const void* b, const void* h_out,
                                       const void* c_out, const void* dh_out, void* dgates,
                                       void* partial, void* dx, void* scratch,
                                       long long scratch_bytes, int batch, int t_len, int feat,
                                       int hidden, int splits, int rows_per_split,
                                       int sweep_rows, int is_bf16, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? launch<bf16>(x, w, u, ut, b, h_out, c_out, dh_out, dgates, partial, dx, scratch,
                       scratch_bytes, batch, t_len, feat, hidden, splits, rows_per_split,
                       sweep_rows, s)
        : launch<float>(x, w, u, ut, b, h_out, c_out, dh_out, dgates, partial, dx, scratch,
                        scratch_bytes, batch, t_len, feat, hidden, splits, rows_per_split,
                        sweep_rows, s);
    return static_cast<int>(err);
}
