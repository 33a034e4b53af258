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
// (a), (c) and (d) are one templated tensor-core product (mma_product, in
// mma_product.cuh with split_pieces and the float32 sweep (b), shared with
// the resident training backward, bilstm_train.cu): 128 x 128 output tiles, 8 warps of 64 x 32, depth 32 a stage, every
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

#include "mma_product.cuh"

namespace {

// ---- (a), (c), (d): the problems of the shared product (mma_product.cuh) ---

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
    // the FMA sweep's layout policy (mma_product.cuh): direction 0 sweeps
    // t = T-1 .. 0, direction 1 t = 0 .. T-1, each keeping its time index
    __device__ int time(int dir, int step) const { return dir == 0 ? t_len - 1 - step : step; }
    __device__ size_t row(int dir, int r, int t) const {
        return (static_cast<size_t>(dir) * batch + r) * t_len + t;
    }
    __device__ size_t cell(int dir, int r, int t) const {
        return (static_cast<size_t>(r) * t_len + t) * 2 * hidden + dir * hidden;
    }
    __device__ int prev(int dir, int t) const {
        const int tp = dir == 0 ? t - 1 : t + 1;
        return tp < t_len ? tp : -1;
    }
};

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

// Rows a sweep block: the tensor-core sweep 16, or 32 from B = 4096 (on an
// H100 at B = 10,000 32 rows ran 7% faster than 16; at B = 512, 16 rows
// 1.1-1.8x faster than 32); the FMA sweep fma_sweep_rows (4, or 8 from
// B = 4096). `rows` > 0 takes that number where the sweep has it (16 or 32;
// 4 or 8).
template <typename T>
cudaError_t launch_sweep(const SweepArgs& s, int rows, cudaStream_t stream) {
    if (sweep_on_tensor_cores<T>(s.hidden)) {
        if (rows <= 0) rows = s.batch >= 4096 ? 32 : 16;
        if (rows == 16) return launch_sweep_mma<16>(s, stream);
        if (rows == 32) return launch_sweep_mma<32>(s, stream);
        return cudaErrorInvalidValue;
    }
    if (rows <= 0) rows = fma_sweep_rows(s.batch);
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
