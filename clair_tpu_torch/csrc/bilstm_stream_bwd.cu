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
//     and dh_carry = dgates . U^T.
//     float32: the cluster sweep of lstm_bwd_sweep.cuh through the policy
//     SweepArgs: a cluster of 2, 4 or 8 CTAs holds U's three bf16 pieces
//     (384 KB at H = 128, a CTA its units' gate columns), each CTA forms
//     its partial dgates . U^T over its own gate columns on mma.sync, and
//     the partials meet through distributed shared memory, summed in rank
//     order; the next step's gates, c and dh_out are loaded while the
//     carry runs.
//     bf16, H <= 128: one block per (row tile, direction) stages its
//     direction's U (H x 4H, 128 KB at H = 128) once into shared memory and
//     runs the carry on mma.sync, 16 or 32 rows a block (every m16 tile
//     full), with the hardware tanh of the forward's bf16 gates; the next
//     step's gates, c and dh_out are loaded while the carry runs. bf16,
//     H > 128: U does not fit one block, so the carry is float32 FMA, U^T
//     streamed from L2 through shared memory in chunks, 4 or 8 rows a block.
// (c) the weight sums dW, dU (A^T . dgates, A = [x | h_prev]) and db over
//     fixed row chunks whose float32 partials the caller adds in a fixed
//     order: deterministic, no atomics.
// (d) dx = [dgates_0 | dgates_1] . [W_0 ; W_1]^T, written once in x's type.
// (a), (c) and (d) run on one of two tensor-core products:
// - bf16 mode, the default training path: wgmma fed by TMA
//   (wgmma_product.cuh, the problems Tma*Problem below): a producer thread
//   keeps a ring of 64-deep shared-memory stages loading through tensor
//   maps of x, h_out, W, U and the dgates' two pieces (whatever a box
//   reaches past an edge arrives as zeros), a fix-up warp zeroes the rows
//   TMA cannot (h_prev at the sequence edge, rows past a weight-sum
//   chunk), two consumer warpgroups run wgmma.mma_async straight from the
//   stages (MN-major operands through the transpose bits), persistent
//   blocks walk the output tiles in a fixed order. (a) tiles 128 rows x
//   256 gates; (c) 128 gates x 192 of [x | h] (dgates^T . A, both pieces;
//   db summed by two side warps from the staged pieces in float32 on the
//   CUDA cores); (d) 128 rows x 256 features.
// - float32 mode: one templated mma.sync product (mma_product, in
//   mma_product.cuh with split_pieces; it and the float32 sweep (b) are
//   shared with the resident training backward, bilstm_train.cu): 128 x
//   128 output tiles, 8 warps of 64 x 32, depth 32 a stage, every
//   operand's bf16 pieces staged by cp.async (zero-filled past every edge)
//   into a ring of three buffers, fragments by ldmatrix (.trans where the
//   operand's rows run along the reduction); the operands split once into
//   three bf16 pieces by split_pieces into scratch before (a).
// bf16 mode's x, h_out, W and U are the tensors themselves, so no block
// converts a tile.
//
// Numerics: bf16 operands and float32 sums on the tensor cores (wgmma
// m64nNk16 in bf16 mode, mma.sync m16n8k16 in float32 mode), no TF32.
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
// db is no product: each row's pieces are added, then the row is added to
// a float32 sum on the CUDA cores, rows in order (in both modes; the
// tensor cores' float32 accumulate rounds toward zero, and over B*T rows
// that bias would show). The float32 sweep's carry takes the three-piece
// dgates against three-piece U (six passes); the bf16 sweep's the 2-piece
// dgates against bf16 U.
//
// What bounds each kernel (B = 10,000, T = 33, H = 128; PERF.md has the
// measured split):
// - (a), (c), (d): tensor-core operations: 2 * 2 * B*T * (F + H) * 4H for
//   (a) and for (c), 2 * B*T * 8H * F for (d), times the passes; and the
//   float32 dgates buffer (1.35 GB a layer), written by (a), read and
//   written by (b), read by (c) and (d). In bf16 mode the bytes rule
//   (about 8 GB a train step, 2.4 ms at 3.35 TB/s, against 1.09 ms of
//   operations): on the card (a) is bound by its float32 stores and (c)
//   and (d) by their loads (tools/torch_bwd_products.py times each with its
//   products or its stores removed).
// - (b): the serial chain of 33 steps (a step's loads, the elementwise
//   backward, a barrier, the carry's dependent k16 steps; in float32 also
//   the exchange of the partial sums), and its bytes: gates, c and dh_out
//   read, the dgates' pieces written.
// Measured split, ms at B = 10,000 on an H100 80GB HBM3 at 700 W
// (tools/torch_stream_bwd_parts.py, torch.profiler device time):
//   the first design (gates recomputed on the serial chain, FMA products):
//     bf16 lstm1 sweep 12.633, sums 7.491; lstm2 sweep 20.271, sums 14.238,
//     dx 5.904 (60.77 both layers); f32 lstm1 sweep 11.434, sums 4.915;
//     lstm2 sweep 18.951, sums 9.186, dx 6.463 (51.26 both layers).
//   products on mma.sync in both modes: bf16 lstm1 gates 0.906, sweep
//     1.857, sums 1.341; lstm2 gates 1.512, sweep 1.854, sums 1.846, dx
//     1.294 (10.72 both layers).
//   this design: bf16 lstm1 gates 0.607, sweep 1.844, sums 0.517; lstm2
//     gates 0.744, sweep 1.848, sums 0.927, dx 0.585 (7.20 both layers);
//     f32 lstm1 gates 2.243, sweep 3.903, sums 3.146, pieces 0.397; lstm2
//     gates 4.623, sweep 3.912, sums 4.467, dx 3.067, pieces 0.707 (26.9
//     both layers).
// Left for later: one read of dgates feeding both dx and the weight sums;
// the bf16 loads of (c) and (d) (each row's 128-byte segments 2 KB apart;
// a cluster of two CTAs sharing one operand by TMA multicast did not speed
// them); the float32 products on wgmma_product (three pieces an operand).

#include "lstm_bwd_sweep.cuh"
#include "wgmma_product.cuh"

namespace {

// ---- float32 mode's (a), (c), (d): problems of the mma.sync product (mma_product.cuh)

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
struct GateProblem {
    static constexpr bool kAK = true, kBKMajor = false;  // A [m][k]; B [k][g]
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
struct WeightSumProblem {
    static constexpr bool kAK = false, kBKMajor = false;  // A [m][a]; B [m][g]
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
struct DxProblem {
    static constexpr bool kAK = true, kBKMajor = true;  // A [m][kk]; B [f][kk]
    static constexpr bool kDb = false;
    Pieces dg, w;
    float* dx;
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
        float* o = dx + static_cast<size_t>(m) * feat + f;
        o[0] = v0;
        o[1] = v1;
    }
    __device__ void store_db(int, float) const {}
};

// ---- bf16 mode's (a), (c), (d): wgmma fed by TMA (wgmma_product.cuh) --------
//
// The same three products on bf16 operands, each a single piece except the
// dgates' two (hi and lo, interleaved in each row where the sweep wrote them
// over the gates): the tensor maps read x (B*T, F), h_out as (B*T, 2, H)
// (a direction's H columns; a box reaching past H loads zeros), W and U as
// (2, K, 4H) and the dgates as (2, B*T, 2, 4H) (direction, row, piece,
// gate). Boxes are 64 bf16 wide; widths below 64 (F = 32 at lstm1, H = 8)
// and ragged row counts arrive zero-filled and are never stored.
// h_prev is h_out one row up (direction 0) or down (direction 1) of the
// flat B*T rows; a box reads it so, and the fix-up warp zeroes the rows at
// the sequence edge (t = 0, or t = T-1), which belong to the neighbouring
// sequence.

// Whether row m = b*T + t of direction dir has no h_prev (the zero state).
__device__ __forceinline__ bool seq_edge(int m, int t_len, int dir) {
    return m % t_len == (dir == 0 ? 0 : t_len - 1);
}

// (a) gates[dir][m][g] = [x | h_prev][m] . [W ; U][:, g] + b[g]: a tile is
// 128 rows x 256 gates of one direction; its reduction x's F columns in
// boxes of 64, then h_prev's H. A [m][k] (K-major), B [k][g] (MN-major).
struct TmaGateProblem {
    static constexpr int kN = 256;
    static constexpr int kStages = 4;
    static constexpr int kStageBytes = kWgBM * kRowBytes + (kN / 64) * kBoxBytes;  // 48 KB
    // the epilogue's chunks: 64 rows x 32 gates of float32 (128-byte rows),
    // two buffers a consumer warpgroup
    static constexpr int kChunk = 32, kChunkBytes = kWgRows * kRowBytes;
    static constexpr int kExtraBytes = 2 * 2 * kChunkBytes;
    static constexpr bool kFix = true;
    static constexpr int kSideWarps = 0;
    using Acc = WgmmaAcc<kN>;
    CUtensorMap x_map;  // x (B*T, F), box 64 x 128 rows
    CUtensorMap h_map;  // h_out (B*T, 2, H), box 64 x 1 x 128 rows
    CUtensorMap w_map;  // W (2, F, 4H), box 64 gates x 64 x 1
    CUtensorMap u_map;  // U (2, H, 4H), box 64 gates x 64 x 1
    CUtensorMap out_map;  // gates (2, B*T, 4H) float32, box 32 gates x 64 rows x 1
    const float* b;
    int rows, t_len, hidden, m_tiles, n_tiles, x_steps, h_steps;

    __host__ __device__ int tiles() const { return 2 * m_tiles * n_tiles; }
    // tile = (dir * m_tiles + m tile) * n_tiles + n tile
    __device__ void at(int tile, int& dir, int& m0, int& n0) const {
        n0 = (tile % n_tiles) * kN;
        m0 = ((tile / n_tiles) % m_tiles) * kWgBM;
        dir = tile / (n_tiles * m_tiles);
    }
    __device__ int k_steps(int) const { return x_steps + h_steps; }
    __device__ unsigned stage_bytes(int) const { return kStageBytes; }
    __device__ void load(int tile, int k, unsigned char* s, uint64_t* bar) const {
        int dir, m0, n0;
        at(tile, dir, m0, n0);
        unsigned char* b_s = s + kWgBM * kRowBytes;
        const bool x_step = k < x_steps;
        const int k0 = (x_step ? k : k - x_steps) * 64;
        if (x_step) tma_load(s, &x_map, bar, k0, m0);
        else tma_load(s, &h_map, bar, k0, dir, m0 + (dir == 0 ? -1 : 1));
#pragma unroll
        for (int j = 0; j < kN / 64; ++j)
            tma_load(b_s + j * kBoxBytes, x_step ? &w_map : &u_map, bar, n0 + 64 * j, k0, dir);
    }
    __device__ void fix(int tile, int k, unsigned char* s, int lane) const {
        if (k < x_steps) return;
        int dir, m0, n0;
        at(tile, dir, m0, n0);
        for (int r = lane; r < kWgBM; r += 32)
            if (m0 + r < rows && seq_edge(m0 + r, t_len, dir)) zero_row(s, r);
    }
    __device__ void mma(Acc& acc, const unsigned char* stage, int half, int) const {
        const uint32_t s = smem_u32(stage);
        const uint32_t a = s + half * kWgRows * kRowBytes, bt = s + kWgBM * kRowBytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) wgmma_bf16<kN, 0, 1>(acc.d, k_major_at(a, kk), mn_major_at(bt, kk));
    }
    // The warpgroup's 64 x 256 gates plus the bias, 32 gates at a time: into
    // a chunk buffer in the 128-byte swizzle, then one thread's TMA store,
    // which reads the buffer while the next chunk fills the other one. A
    // tile's chunk 0 waits for every earlier store: the block's previous
    // tile may have ended on either buffer (an odd count of chunks where
    // 4H mod 256 is an odd multiple of 32, as at H = 8).
    __device__ void store(int tile, int half, const Acc& acc, unsigned char* extra) const {
        int dir, m0, n0;
        at(tile, dir, m0, n0);
        const int t = threadIdx.x & 127, l = t & 31, gates = 4 * hidden;
        const int r0 = (t >> 5) * 16 + (l >> 2);  // this thread's rows r0 and r0 + 8
        const float* bd = b + dir * gates + n0;
#pragma unroll
        for (int c = 0; c < kN / kChunk; ++c) {
            if (n0 + c * kChunk >= gates) break;  // 4H is a multiple of 32: chunks are whole
            unsigned char* buf = extra + (half * 2 + (c & 1)) * kChunkBytes;
            if (t == 0) {  // the store that last read this buffer is done
                if (c == 0) bulk_wait_read<0>();
                else bulk_wait_read<1>();
            }
            named_barrier(1 + half, 128);
#pragma unroll
            for (int jj = 0; jj < kChunk / 8; ++jj) {
                const int j = c * (kChunk / 8) + jj, col = 8 * jj + 2 * (l & 3);
                const float2 bias = *reinterpret_cast<const float2*>(bd + c * kChunk + col);
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int r = r0 + 8 * h;
                    *reinterpret_cast<float2*>(buf + r * kRowBytes +
                                               (((col >> 2) ^ (r & 7)) << 4) + (col & 3) * 4) =
                        make_float2(acc.d[4 * j + 2 * h] + bias.x, acc.d[4 * j + 2 * h + 1] + bias.y);
                }
            }
            fence_proxy_async();
            named_barrier(1 + half, 128);
            if (t == 0) {
                tma_store(buf, &out_map, n0 + c * kChunk, m0 + half * kWgRows, dir);
                bulk_commit();
            }
        }
    }
};

// (c) partial[split][dir][a][g] = sum over the chunk's rows m of
// A[m][a] * dgates[dir][m][g] (A = [x | h_prev]), and row F + H the chunk's
// sum of dgates. Computed transposed, as dgates^T . A: a tile is 128 gates
// x three boxes of A's columns (x's boxes of 64, then h_prev's), both
// operands MN-major (rows along the reduction), both dgates pieces against
// the same A. db is summed from the staged dgates by two side warps on the
// CUDA cores beside the consumers' wgmma: side warp w sums the tile's gates
// 64w .. 64w + 63 in the tiles at n tile w % n_tiles (so that the n tiles,
// which read the same dgates side by side, carry the same work); a lane
// takes two gates, and for each row in order adds the row's two pieces,
// then the row to its float32 sum (the float32 mode's order,
// mma_product.cuh). The fix-up warp zeroes h_prev's edge rows and, in a
// chunk's last stage, the dgates rows past the chunk (the next chunk's).
struct TmaWeightSumProblem {
    static constexpr int kBoxes = 3;
    static constexpr int kN = 64 * kBoxes;
    static constexpr int kABytes = 2 * 2 * kBoxBytes;  // 2 pieces x 128 gates
    static constexpr int kStages = 4;
    static constexpr int kStageBytes = kABytes + kBoxes * kBoxBytes;  // 56 KB
    static constexpr int kExtraBytes = 0;
    static constexpr bool kFix = true;
    static constexpr int kSideWarps = 2;  // db of the tile's gates 0-63 and 64-127
    using Acc = WgmmaAcc<kN>;
    struct Side {
        float db[2];  // the sums of this lane's two gates
    };
    CUtensorMap dg_map;  // dgates (2, B*T, 2, 4H), box 64 gates x 1 x 64 rows x 1
    CUtensorMap x_map;   // x (B*T, F), box 64 x 64 rows
    CUtensorMap h_map;   // h_out (B*T, 2, H), box 64 x 1 x 64 rows
    float* partial;
    int rows, t_len, feat, hidden, splits, rows_per_split, m_tiles, n_tiles, x_boxes, h_boxes;

    __host__ __device__ int tiles() const { return splits * 2 * m_tiles * n_tiles; }
    // tile = (slab * m_tiles + m tile) * n_tiles + n tile, slab = split * 2 + dir
    __device__ void at(int tile, int& slab, int& g0, int& nt) const {
        nt = tile % n_tiles;
        g0 = ((tile / n_tiles) % m_tiles) * kWgBM;
        slab = tile / (n_tiles * m_tiles);
    }
    __device__ int k_begin(int slab) const { return (slab >> 1) * rows_per_split; }
    __device__ int k_end(int slab) const { return min(rows, k_begin(slab) + rows_per_split); }
    __device__ int k_steps(int tile) const {
        int slab, g0, nt;
        at(tile, slab, g0, nt);
        return (k_end(slab) - k_begin(slab) + kWgBK - 1) / kWgBK;
    }
    __device__ int boxes(int nt) const { return min(kBoxes, x_boxes + h_boxes - nt * kBoxes); }
    __device__ unsigned stage_bytes(int tile) const {
        return kABytes + boxes(tile % n_tiles) * kBoxBytes;
    }
    __device__ void load(int tile, int k, unsigned char* s, uint64_t* bar) const {
        int slab, g0, nt;
        at(tile, slab, g0, nt);
        const int dir = slab & 1, k0 = k_begin(slab) + k * kWgBK;
#pragma unroll
        for (int piece = 0; piece < 2; ++piece)
#pragma unroll
            for (int h = 0; h < 2; ++h)
                tma_load(s + (piece * 2 + h) * kBoxBytes, &dg_map, bar, g0 + h * kWgRows, piece, k0,
                         dir);
        unsigned char* b_s = s + kABytes;
        for (int j = 0; j < boxes(nt); ++j) {
            const int box = nt * kBoxes + j;
            if (box < x_boxes) tma_load(b_s + j * kBoxBytes, &x_map, bar, box * 64, k0);
            else tma_load(b_s + j * kBoxBytes, &h_map, bar, (box - x_boxes) * 64, dir,
                          k0 + (dir == 0 ? -1 : 1));
        }
    }
    __device__ void fix(int tile, int k, unsigned char* s, int lane) const {
        int slab, g0, nt;
        at(tile, slab, g0, nt);
        const int dir = slab & 1, k0 = k_begin(slab) + k * kWgBK, end = k_end(slab);
        const int first_h = max(0, x_boxes - nt * kBoxes), n_boxes = boxes(nt);
        for (int r = lane; r < kWgBK; r += 32) {
            const int m = k0 + r;
            if (m >= end) {
#pragma unroll
                for (int q = 0; q < 4; ++q) zero_row(s + q * kBoxBytes, r);
            } else if (first_h < n_boxes && seq_edge(m, t_len, dir)) {
                for (int j = first_h; j < n_boxes; ++j) zero_row(s + kABytes + j * kBoxBytes, r);
            }
        }
    }
    __device__ void mma(Acc& acc, const unsigned char* stage, int half, int) const {
        const uint32_t s = smem_u32(stage), bt = s + kABytes;
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int piece = 0; piece < 2; ++piece)
                wgmma_bf16<kN, 1, 1>(acc.d, mn_major_at(s + (piece * 2 + half) * kBoxBytes, kk),
                                     mn_major_at(bt, kk));
    }
    // db of gates 2 lane, 2 lane + 1 of the tile's half `warp`: the stage's
    // 64 rows in order (rows past the chunk or the tensor are zeros), eight
    // rows' loads in flight before their sums; a row's 128 bytes hold 64
    // gates as 16-byte chunks permuted by the swizzle (row r's by r & 7)
    __device__ void side(Side& st, int tile, const unsigned char* stage, int warp, int lane) const {
        if (tile % n_tiles != warp % n_tiles) return;
        const uint32_t p0 = smem_u32(stage) + warp * kBoxBytes + (lane & 3) * 4;
        const uint32_t p1 = p0 + 2 * kBoxBytes;
#pragma unroll 1
        for (int r0 = 0; r0 < kWgBK; r0 += 8) {
            uint32_t v0[8], v1[8];
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const uint32_t at = (r0 + i) * kRowBytes + (((lane >> 2) ^ i) << 4);
                v0[i] = ld_shared_b32(p0 + at);
                v1[i] = ld_shared_b32(p1 + at);
            }
#pragma unroll
            for (int i = 0; i < 8; ++i) {
                const float2 a = bf16x2_float2(v0[i]), b = bf16x2_float2(v1[i]);
                st.db[0] += a.x + b.x;
                st.db[1] += a.y + b.y;
            }
        }
    }
    __device__ void side_store(const Side& st, int tile, int warp, int lane) const {
        int slab, g0, nt;
        at(tile, slab, g0, nt);
        const int gates = 4 * hidden, g = g0 + warp * kWgRows + 2 * lane;
        if (nt != warp % n_tiles || g >= gates) return;  // 4H is a multiple of 32: g + 1 too
        float* out = partial + (static_cast<size_t>(slab) * (feat + hidden + 1) + feat + hidden) * gates;
        *reinterpret_cast<float2*>(out + g) = make_float2(st.db[0], st.db[1]);
    }
    __device__ void store(int tile, int half, const Acc& acc, unsigned char*) const {
        int slab, g0, nt;
        at(tile, slab, g0, nt);
        const int l = threadIdx.x & 31, gates = 4 * hidden;
        const int g = g0 + half * kWgRows + ((threadIdx.x >> 5) & 3) * 16 + (l >> 2);
        float* out = partial + static_cast<size_t>(slab) * (feat + hidden + 1) * gates;
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
            const int box = nt * kBoxes + j / 8, c = (j % 8) * 8 + 2 * (l & 3);
            int a;  // A's column of this fragment column (and the next)
            if (box < x_boxes) a = box * 64 + c < feat ? box * 64 + c : -1;
            else a = (box - x_boxes) * 64 + c < hidden ? feat + (box - x_boxes) * 64 + c : -1;
            if (box >= x_boxes + h_boxes || a < 0) continue;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
                if (g + 8 * h >= gates) continue;
                out[static_cast<size_t>(a) * gates + g + 8 * h] = acc.d[4 * j + 2 * h];
                out[static_cast<size_t>(a + 1) * gates + g + 8 * h] = acc.d[4 * j + 2 * h + 1];
            }
        }
    }
};

// (d) dx[m][f] = sum over dir, g of dgates[dir][m][g] * W[dir][f][g], both
// pieces: a tile is 128 rows x 256 features; the reduction runs over both
// directions' 4H gates in boxes of 64. A [m][g] and B [f][g], both K-major.
struct TmaDxProblem {
    static constexpr int kN = 256;
    static constexpr int kABytes = 2 * kWgBM * kRowBytes;  // 2 pieces x 128 rows
    static constexpr int kStages = 3;
    static constexpr int kStageBytes = kABytes + kN * kRowBytes;  // 64 KB
    static constexpr int kExtraBytes = 0;
    static constexpr bool kFix = false;
    static constexpr int kSideWarps = 0;
    using Acc = WgmmaAcc<kN>;
    CUtensorMap dg_map;  // dgates (2, B*T, 2, 4H), box 64 gates x 1 x 128 rows x 1
    CUtensorMap w_map;   // W (2, F, 4H), box 64 gates x 256 x 1
    bf16* dx;
    int rows, feat, m_tiles, n_tiles, g_steps;

    __host__ __device__ int tiles() const { return m_tiles * n_tiles; }
    __device__ int k_steps(int) const { return 2 * g_steps; }
    __device__ unsigned stage_bytes(int) const { return kStageBytes; }
    __device__ void load(int tile, int k, unsigned char* s, uint64_t* bar) const {
        const int m0 = (tile / n_tiles) * kWgBM, n0 = (tile % n_tiles) * kN;
        const int dir = k / g_steps, g0 = (k % g_steps) * 64;
#pragma unroll
        for (int piece = 0; piece < 2; ++piece)
            tma_load(s + piece * kWgBM * kRowBytes, &dg_map, bar, g0, piece, m0, dir);
        tma_load(s + kABytes, &w_map, bar, g0, n0, dir);
    }
    __device__ void fix(int, int, unsigned char*, int) const {}
    __device__ void mma(Acc& acc, const unsigned char* stage, int half, int) const {
        const uint32_t s = smem_u32(stage);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int piece = 0; piece < 2; ++piece)
                wgmma_bf16<kN, 0, 0>(acc.d,
                                 k_major_at(s + (piece * kWgBM + half * kWgRows) * kRowBytes, kk),
                                 k_major_at(s + kABytes, kk));
    }
    __device__ void store(int tile, int half, const Acc& acc, unsigned char*) const {
        const int m0 = (tile / n_tiles) * kWgBM, n0 = (tile % n_tiles) * kN;
        const int l = threadIdx.x & 31;
        const int row = m0 + half * kWgRows + ((threadIdx.x >> 5) & 3) * 16 + (l >> 2);
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
            const int f = n0 + 8 * j + 2 * (l & 3);
            if (f >= feat) continue;  // F is a multiple of 8: f + 1 is real too
#pragma unroll
            for (int h = 0; h < 2; ++h)
                if (row + 8 * h < rows)
                    *reinterpret_cast<__nv_bfloat162*>(dx + static_cast<size_t>(row + 8 * h) * feat + f) =
                        __floats2bfloat162_rn(acc.d[4 * j + 2 * h], acc.d[4 * j + 2 * h + 1]);
        }
    }
};

// The tensor maps of bf16 mode's operands, boxes `box_rows` rows deep.
cudaError_t x_map(CUtensorMap* map, const void* x, int rows, int feat, int box_rows) {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(feat), static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[1] = {2ull * feat};
    const cuuint32_t box[2] = {64, static_cast<cuuint32_t>(box_rows)};
    return bf16_map(map, x, dims, strides, box);
}
cudaError_t h_map(CUtensorMap* map, const void* h_out, int rows, int hidden, int box_rows) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hidden), 2, static_cast<cuuint64_t>(rows)};
    const cuuint64_t strides[2] = {2ull * hidden, 4ull * hidden};
    const cuuint32_t box[3] = {64, 1, static_cast<cuuint32_t>(box_rows)};
    return bf16_map(map, h_out, dims, strides, box);
}
// W or U, (2, k_rows, 4H)
cudaError_t weight_map(CUtensorMap* map, const void* w, int k_rows, int gates, int box_rows) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(gates), static_cast<cuuint64_t>(k_rows), 2};
    const cuuint64_t strides[2] = {2ull * gates, 2ull * gates * k_rows};
    const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(box_rows), 1};
    return bf16_map(map, w, dims, strides, box);
}
// the dgates' two pieces in place of the (2, B*T, 4H) float32 gates
cudaError_t dgates_map(CUtensorMap* map, const void* dg, int rows, int gates, int box_rows) {
    const cuuint64_t dims[4] = {static_cast<cuuint64_t>(gates), 2, static_cast<cuuint64_t>(rows), 2};
    const cuuint64_t strides[3] = {2ull * gates, 4ull * gates, 4ull * gates * rows};
    const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(box_rows), 1};
    return bf16_map(map, dg, dims, strides, box);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

cudaError_t tma_gates(const void* x, const void* w, const void* u, const void* b,
                      const void* h_out, float* gates_out, int rows, int t_len, int feat,
                      int hidden, cudaStream_t stream) {
    TmaGateProblem p{};
    const int gates = 4 * hidden;
    cudaError_t err = x_map(&p.x_map, x, rows, feat, kWgBM);
    if (err == cudaSuccess) err = h_map(&p.h_map, h_out, rows, hidden, kWgBM);
    if (err == cudaSuccess) err = weight_map(&p.w_map, w, feat, gates, 64);
    if (err == cudaSuccess) err = weight_map(&p.u_map, u, hidden, gates, 64);
    if (err == cudaSuccess) {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(gates), static_cast<cuuint64_t>(rows), 2};
        const cuuint64_t strides[2] = {4ull * gates, 4ull * gates * rows};
        const cuuint32_t box[3] = {TmaGateProblem::kChunk, kWgRows, 1};
        err = tensor_map(&p.out_map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, gates_out, dims, strides, box);
    }
    if (err != cudaSuccess) return err;
    p.b = static_cast<const float*>(b);
    p.rows = rows;
    p.t_len = t_len;
    p.hidden = hidden;
    p.m_tiles = ceil_div(rows, kWgBM);
    p.n_tiles = ceil_div(gates, TmaGateProblem::kN);
    p.x_steps = ceil_div(feat, 64);
    p.h_steps = ceil_div(hidden, 64);
    return launch_wgmma(p, p.tiles(), stream);
}

cudaError_t tma_weight_sums(const void* x, const void* h_out, const void* dgates, float* partial,
                            int rows, int t_len, int feat, int hidden, int splits,
                            int rows_per_split, cudaStream_t stream) {
    TmaWeightSumProblem p{};
    const int gates = 4 * hidden;
    cudaError_t err = dgates_map(&p.dg_map, dgates, rows, gates, kWgBK);
    if (err == cudaSuccess) err = x_map(&p.x_map, x, rows, feat, kWgBK);
    if (err == cudaSuccess) err = h_map(&p.h_map, h_out, rows, hidden, kWgBK);
    if (err != cudaSuccess) return err;
    p.partial = partial;
    p.rows = rows;
    p.t_len = t_len;
    p.feat = feat;
    p.hidden = hidden;
    p.splits = splits;
    p.rows_per_split = rows_per_split;
    p.m_tiles = ceil_div(gates, kWgBM);
    p.x_boxes = ceil_div(feat, 64);
    p.h_boxes = ceil_div(hidden, 64);
    p.n_tiles = ceil_div(p.x_boxes + p.h_boxes, TmaWeightSumProblem::kBoxes);
    return launch_wgmma(p, p.tiles(), stream);
}

cudaError_t tma_dx(const void* dgates, const void* w, void* dx, int rows, int feat, int hidden,
                   cudaStream_t stream) {
    TmaDxProblem p{};
    const int gates = 4 * hidden;
    cudaError_t err = dgates_map(&p.dg_map, dgates, rows, gates, kWgBM);
    if (err == cudaSuccess) err = weight_map(&p.w_map, w, feat, gates, TmaDxProblem::kN);
    if (err != cudaSuccess) return err;
    p.dx = static_cast<bf16*>(dx);
    p.rows = rows;
    p.feat = feat;
    p.m_tiles = ceil_div(rows, kWgBM);
    p.n_tiles = ceil_div(feat, TmaDxProblem::kN);
    p.g_steps = ceil_div(gates, 64);
    return launch_wgmma(p, p.tiles(), stream);
}

// ---- (b): the reverse sweep ------------------------------------------------

struct SweepArgs {
    const float* gates;   // (2, B*T, 4H) float32 pre-activations
    bf16* pieces;         // dgates out: rows (dir, m) of pieces x 4H bf16 (bf16: 2, float32: 3)
    const float* c_out;   // (B, T, 2H) float32
    const void* dh_out;   // (B, T, 2H) in T
    const void* u;        // (2, H, 4H) in T
    const void* ut;       // bf16, H > 128: (2, 4H, H), U transposed (the FMA carry)
    int batch, t_len, hidden;
    // the layout policy of the float32 sweep (lstm_bwd_sweep.cuh) and of the
    // bf16 FMA sweep: direction 0 sweeps t = T-1 .. 0, direction 1
    // t = 0 .. T-1, each keeping its time index
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
// ---- the bf16 FMA sweep, H > 128 ---------------------------------------------

// One (row, unit)'s step: its gates, c_t, c_prev and dh_out.
struct Cell {
    float a[4], c, c_prev, dh_out;
};

// The values of (row, t, unit j) into v; with_c false takes c_t from
// v.c_prev, the last step's c_prev (the sweep walks t one step at a time).
__device__ __forceinline__ void load_cell(const SweepArgs& s, int dir, int row, int t, int j,
                                          Cell& v, bool with_c) {
    const float c_t = v.c_prev;
    v = Cell{};
    if (row >= s.batch) return;
    const int hidden = s.hidden, gates = 4 * hidden;
    const float* g = s.gates + s.row(dir, row, t) * gates + j;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.a[q] = g[q * hidden];
    const size_t at = s.cell(dir, row, t) + j;
    v.c = with_c ? s.c_out[at] : c_t;
    v.dh_out = to_float(static_cast<const bf16*>(s.dh_out)[at]);
    const int tp = s.prev(dir, t);
    if (tp >= 0) v.c_prev = s.c_out[s.cell(dir, row, tp) + j];
}

// The dgates of (row, t, unit j) as the sweep's two bf16 pieces, in place
// of the entry's gates.
__device__ __forceinline__ void store_pieces(const SweepArgs& s, int dir, int row, int t, int j,
                                             const float (&dg)[4]) {
    const int gates = 4 * s.hidden;
    bf16* out = s.pieces + s.row(dir, row, t) * 2 * gates + j;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
        const bf16 hi = __float2bfloat16_rn(dg[g]);
        out[g * s.hidden] = hi;
        out[gates + g * s.hidden] = __float2bfloat16_rn(dg[g] - __bfloat162float(hi));
    }
}

// The bf16 sweep where U does not fit one block (H > 128), the carry in
// float32 FMA. blockDim.x == H, a thread owning one unit of every row;
// gridDim = (ceil(batch / R), 2), blockIdx.y the direction. U^T streams
// through shared memory in chunks of `FmaLayout::chunk` rows (cp.async, two
// buffers), read by every row of the block. A step reads its R rows' gates
// before any thread writes their pieces (which overwrite the gates in
// place).
template <int R>
struct FmaLayout {
    int chunk;  // rows of U^T a stage: 32, fewer where 32 rows pass 32 KB
    size_t ut_off, total;
    __host__ __device__ explicit FmaLayout(int hidden) {
        chunk = 32;
        while (chunk > 4 && static_cast<size_t>(chunk) * hidden * sizeof(bf16) > 32 * 1024) chunk /= 2;
        ut_off = sizeof(float) * R * 5 * static_cast<size_t>(hidden);  // dh_s (R, H), dg_s (R, 4H)
        total = ut_off + 2 * static_cast<size_t>(chunk) * hidden * sizeof(bf16);
    }
};

template <int R>
__global__ void bilstm_bwd_sweep_fma(const SweepArgs s) {
    // (named apart from the other kernels' dynamic shared memory)
    extern __shared__ __align__(16) unsigned char sweep_smem[];
    const int hidden = blockDim.x, gates = 4 * hidden;
    const FmaLayout<R> L(hidden);
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * R;
    float* dh_s = reinterpret_cast<float*>(sweep_smem);  // (R, H): dh_carry
    float* dg_s = dh_s + R * hidden;               // (R, 4H): this step's dgates
    bf16* ut_s = reinterpret_cast<bf16*>(sweep_smem + L.ut_off);  // 2 x (chunk, H) of U^T
    const bf16* utd = static_cast<const bf16*>(s.ut) + static_cast<size_t>(dir) * gates * hidden;
    constexpr int per = 16 / sizeof(bf16);
    const int chunk_copies = L.chunk * hidden / per;
    auto stage_ut = [&](int c, int buf) {
        const bf16* src = utd + static_cast<size_t>(c) * L.chunk * hidden;
        bf16* dst = ut_s + static_cast<size_t>(buf) * L.chunk * hidden;
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
        for (int r = 0; r < R; ++r) load_cell(s, dir, row0 + r, t, j, cell[r], step == 0);
        __syncthreads();  // every gate of the step is read; dh_s and dg_s are free
#pragma unroll
        for (int r = 0; r < R; ++r) {
            float dg[4] = {0.0f, 0.0f, 0.0f, 0.0f};
            if (row0 + r < s.batch) {
                cell_backward<bf16>(cell[r].a, cell[r].c, cell[r].c_prev,
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
            const bf16* us = ut_s + static_cast<size_t>(c & 1) * L.chunk * hidden + j;
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

template <int R>
cudaError_t launch_sweep_fma(const SweepArgs& s, cudaStream_t stream) {
    const size_t smem = FmaLayout<R>(s.hidden).total;
    if (smem > kSmemLimit) return cudaErrorInvalidValue;
    const cudaError_t err = allow_dynamic_smem(bilstm_bwd_sweep_fma<R>, smem);
    if (err != cudaSuccess) return err;
    bilstm_bwd_sweep_fma<R><<<dim3((s.batch + R - 1) / R, 2), dim3(s.hidden), smem, stream>>>(s);
    return cudaGetLastError();
}

template <int R>
cudaError_t launch_sweep_mma(const SweepArgs& s, cudaStream_t stream) {
    const size_t smem = SweepLayout<R>(s.hidden).total;
    const cudaError_t err = allow_dynamic_smem(bilstm_bwd_sweep_mma<R>, smem);
    if (err != cudaSuccess) return err;
    bilstm_bwd_sweep_mma<R><<<dim3((s.batch + R - 1) / R, 2), kThreads, smem, stream>>>(s);
    return cudaGetLastError();
}

// The bf16 sweep, chosen by the shape alone: U in shared memory and the
// carry on the tensor cores where H <= 128, 16 rows a block or 32 from
// B = 4096 (on an H100 at B = 10,000 32 rows ran 7% faster than 16; at
// B = 512, 16 rows 1.1-1.8x faster than 32); else the FMA sweep, 4 rows a
// block or 8 from B = 4096 (as the float32 FMA sweep it came from ran
// fastest). `rows` > 0 takes that number where the sweep has it (16 or 32;
// 4 or 8).
cudaError_t launch_bf16_sweep(const SweepArgs& s, int rows, cudaStream_t stream) {
    if (s.hidden <= 128) {
        if (rows <= 0) rows = s.batch >= 4096 ? 32 : 16;
        if (rows == 16) return launch_sweep_mma<16>(s, stream);
        if (rows == 32) return launch_sweep_mma<32>(s, stream);
        return cudaErrorInvalidValue;
    }
    if (rows <= 0) rows = s.batch >= 4096 ? 8 : 4;
    if (rows == 4) return launch_sweep_fma<4>(s, stream);
    if (rows == 8) return launch_sweep_fma<8>(s, stream);
    return cudaErrorInvalidValue;
}

// The float32 scratch: the three pieces of x, h_out, W, U and the dgates.
size_t scratch_elems(size_t rows, int feat, int hidden) {
    const size_t gates = 4 * static_cast<size_t>(hidden);
    return 3 * (rows * feat + rows * 2 * hidden + 2 * feat * gates + 2 * hidden * gates +
                2 * rows * gates);
}

// bf16: the products on wgmma fed by TMA, the dgates' two pieces in place
// of the gates.
cudaError_t launch_bf16(const void* x, const void* w, const void* u, const void* ut, const void* b,
                        const void* h_out, const void* c_out, const void* dh_out, void* dgates,
                        void* partial, void* dx, int batch, int t_len, int feat, int hidden,
                        int splits, int rows_per_split, int sweep_rows, cudaStream_t stream) {
    const int rows = batch * t_len;
    float* gate_buf = static_cast<float*>(dgates);
    cudaError_t err = tma_gates(x, w, u, b, h_out, gate_buf, rows, t_len, feat, hidden, stream);
    if (err != cudaSuccess) return err;
    const SweepArgs s{gate_buf, static_cast<bf16*>(dgates), static_cast<const float*>(c_out),
                      dh_out, u, ut, batch, t_len, hidden};
    err = launch_bf16_sweep(s, sweep_rows, stream);
    if (err != cudaSuccess) return err;
    err = tma_weight_sums(x, h_out, dgates, static_cast<float*>(partial), rows, t_len, feat, hidden,
                          splits, rows_per_split, stream);
    if (err != cudaSuccess || dx == nullptr) return err;
    return tma_dx(dgates, w, dx, rows, feat, hidden, stream);
}

// float32: three bf16 pieces of every operand on the mma.sync product; the
// sweep's geometry first, so one that does not fit launches nothing.
cudaError_t launch_f32(const void* x, const void* w, const void* u, const void* b,
                       const void* h_out, const void* c_out, const void* dh_out, void* dgates,
                       void* partial, void* dx, void* scratch, long long scratch_bytes, int batch,
                       int t_len, int feat, int hidden, int splits, int rows_per_split,
                       int sweep_cluster, int sweep_rows, cudaStream_t stream) {
    const int rows = batch * t_len, gates = 4 * hidden;
    float* gate_buf = static_cast<float*>(dgates);
    int per_dir = 0;
    cudaError_t err = plan_bwd_sweep<SweepArgs>(batch, hidden, sweep_cluster, sweep_rows, per_dir);
    if (err != cudaSuccess) return err;
    if (scratch == nullptr ||
        static_cast<size_t>(scratch_bytes) < sizeof(bf16) * scratch_elems(rows, feat, hidden))
        return cudaErrorInvalidValue;
    Pieces xp, hp, wp, up, dgp;
    bf16* at = static_cast<bf16*>(scratch);
    auto carve = [&](const void* src, size_t n_rows, int cols, Pieces& out) {
        out = Pieces{at, cols};
        if (src != nullptr && err == cudaSuccess) err = launch_split(src, at, n_rows, cols, stream);
        at += kPieces * n_rows * cols;
    };
    carve(x, rows, feat, xp);
    carve(h_out, rows, 2 * hidden, hp);
    carve(w, 2 * static_cast<size_t>(feat), gates, wp);
    carve(u, 2 * static_cast<size_t>(hidden), gates, up);
    carve(nullptr, 2 * static_cast<size_t>(rows), gates, dgp);  // written by the sweep
    if (err != cudaSuccess) return err;
    const XH xh{xp, hp, rows, t_len, feat, hidden, 1.0f / t_len};

    GateProblem gp{xh, wp, up, static_cast<const float*>(b), gate_buf, gates};
    err = launch_product(gp, gates, rows, 2, stream);
    if (err != cudaSuccess) return err;

    const SweepArgs s{gate_buf, const_cast<bf16*>(dgp.base), static_cast<const float*>(c_out),
                      dh_out, u, nullptr, batch, t_len, hidden};
    err = launch_bwd_sweep(s, sweep_cluster, sweep_rows, per_dir, stream);
    if (err != cudaSuccess) return err;

    WeightSumProblem wsp{xh, dgp, static_cast<float*>(partial), gates, rows_per_split};
    err = launch_product(wsp, gates, feat + hidden, splits * 2, stream);
    if (err != cudaSuccess || dx == nullptr) return err;

    DxProblem dp{dgp, wp, static_cast<float*>(dx), rows, feat, gates};
    return launch_product(dp, feat, rows, 1, stream);
}

}  // namespace

// Plain C entry point for ctypes. is_bf16 selects the element type of x, w,
// u, ut, h_out, dh_out and dx (0: float32, 1: bfloat16); b, c_out, dgates
// and partial are float32. dgates (2, B, T, 4H) holds the gates; in bf16
// their rows are then overwritten in place by the dgates' two bf16 pieces.
// ut, U transposed (2, 4H, H), is read only by the bf16 FMA sweep (H > 128)
// and may be null otherwise. scratch (float32 only; may be null for bf16)
// holds scratch_bytes >= 2 * 3 * (B*T*F + B*T*2H + 2F*4H + 2H*4H + 2*B*T*4H)
// bytes: the bf16 pieces of x, h_out, W, U and the dgates. partial holds
// splits * 2 * (F + H + 1) * 4H floats, chunk `split` covering rows
// [split * rows_per_split, ...) of the B*T rows; dx may be null (no input
// gradient). F and H must be multiples of 8, and every pointer 16-byte
// aligned. The sweep's geometry, for measuring the choice (0: chosen from
// the shape): float32 runs the cluster sweep at sweep_cluster CTAs and
// sweep_rows rows a tile (lstm_bwd_sweep.cuh), cudaErrorInvalidValue
// before any launch where that geometry does not fit; bf16 takes sweep_rows alone (16
// or 32 for the tensor-core sweep, 4 or 8 for the FMA sweep).
// Launches on `stream`, does not synchronise, and returns the first launch
// error as an int (0: none).
extern "C" int clair_bilstm_stream_bwd(const void* x, const void* w, const void* u,
                                       const void* ut, const void* b, const void* h_out,
                                       const void* c_out, const void* dh_out, void* dgates,
                                       void* partial, void* dx, void* scratch,
                                       long long scratch_bytes, int batch, int t_len, int feat,
                                       int hidden, int splits, int rows_per_split,
                                       int sweep_cluster, int sweep_rows, int is_bf16,
                                       void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? launch_bf16(x, w, u, ut, b, h_out, c_out, dh_out, dgates, partial, dx, batch, t_len,
                      feat, hidden, splits, rows_per_split, sweep_rows, s)
        : launch_f32(x, w, u, b, h_out, c_out, dh_out, dgates, partial, dx, scratch,
                     scratch_bytes, batch, t_len, feat, hidden, splits, rows_per_split,
                     sweep_cluster, sweep_rows, s);
    return static_cast<int>(err);
}
