// Forward recurrence of one bidirectional LSTM layer, both directions in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm_stream.py:_fwd_kernel
// (reached through _fwd_pallas and bilstm_train_stream's forward). Same math:
// per step gates = x_t.W + h.U + b accumulated in float32, i, f, o = sigmoid,
// g = tanh, c' = f*c + i*g in float32, h' = o*tanh(c'); h is rounded to the
// input type every step (it feeds the next step's product in that type).
// bfloat16 products run on the tensor cores (mma.sync m16n8k16, bf16
// operands, float32 accumulators: the TPU kernel's bf16 operands with
// preferred_element_type=float32); float32 products are float32 FMA, with
// no TF32.
//
// What bounds it: one layer is 2 * 2B * T * (F + H) * 4H operations (5.5 and
// 13.3 GFLOP for lstm1 and lstm2 at B = 512, T = 33, H = 128), against about
// 17 MB of x and h_out: compute-bound on paper, 0.20 ms for lstm2 at the
// float32 FMA peak and 13 us at the bf16 tensor-core peak. The 33 steps are
// serial, and a step's product is small (rows x (F + H) x 4H), so what the
// first version lost was the weights: each of its blocks re-read W and U from
// L2 every step (6.6 GB at lstm2, B = 512). This version is bound by the
// latency of a step (its h.U, the nonlinearities, two CTA barriers and one
// cluster barrier) in bf16, and by shared-memory loads feeding the FMAs in
// float32 (PERF.md has the measured split).
//
// Design:
// - W and U stay in shared memory for the whole launch. A direction's
//   weights (384 x 512 at lstm2: 384 KB in bf16, 768 KB in float32) exceed a
//   block's 227 KB, so a thread-block cluster of C CTAs shares one (row tile,
//   direction): each CTA owns H/C hidden units and holds the W and U columns
//   of all four gates of its units (gate order in shared memory: i and f of
//   8 units, then g and o of the same 8, so one 16-row mma tile pair gives a
//   lane all four gates of one unit). The cell update needs no exchange.
// - h is exchanged through distributed shared memory: each CTA writes its
//   units' new h into every peer's copy of the (rows x H) h tile, in 16-byte
//   stores, and one cluster barrier per step orders the exchange. h is
//   double-buffered, so that barrier is the only one across CTAs.
// - Only h.U is serial. x_{t+1}.W needs no h, so each step computes it
//   between arriving at the cluster barrier and waiting on it, in the
//   barrier's shadow, from the on-chip W and an x tile staged by cp.async:
//   x crosses device memory once, W and U are read from L2 once per CTA.
// - The grid is persistent: C x min(row tiles, resident clusters / 2) x 2
//   directions; a cluster walks its direction's row tiles, so the weights
//   load once per CTA, not once per tile.
// - A warp takes items of 8 units by 16 rows; a lane owns one unit and two
//   rows of each 8-row n-tile (the mma accumulator layout, kept for float32
//   too), and c stays in shared memory.
// - The launcher picks the cluster size and the rows per tile by a cost
//   fitted to the measured sweep: rounds of row tiles over the clusters the
//   card holds at once (cudaOccupancyMaxActiveClusters), times the cost of a
//   step, which grows with the items per warp and with the cluster size.
// - bf16 takes the hardware tanh (tanh.approx) for the gates; float32 keeps
//   the accurate expf and tanhf.
// - The backward direction reads x[:, T-1-t] and writes its output at the
//   original time index, into the second half of the feature axis; the
//   ragged batch edge, hidden sizes that no cluster divides, and feature
//   sizes that are no multiple of 16 are zero-padded in shared memory.

#include <cooperative_groups.h>

#include <cstdint>
#include <mutex>

#include "lstm_cell.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;      // eight warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxItems = 2;       // warp items per warp
constexpr int kTileN = 8;          // rows of one mma n-tile
constexpr int kItemTiles = 2;      // n-tiles of one warp item: 16 rows share each weight load
constexpr int kItemRows = kTileN * kItemTiles;
constexpr int kMaxCluster = 8;     // the portable cluster size
constexpr size_t kSmemLimit = 227 * 1024;

using Acc = float[kItemTiles][2][4];

struct Params {
    const void* x;
    const void* w;
    const void* u;
    const float* b;
    void* h_out;
    float* c_out;
    int batch, t_len, feat, hidden;
    int uc;       // hidden units per CTA (a multiple of 8)
    int fk, hk;   // the x part and the h part of the product's depth, padded to 16
    int rows;     // rows per tile (a multiple of kItemRows)
    int n_tiles;
    int x_async;  // every x row of a step is 16-byte chunks
    int vec;      // H = C * uc and 16-byte aligned tensors: vector loads and stores
};

// Shared memory carve-up, in elements of T unless named otherwise.
template <typename T>
struct Layout {
    static constexpr int kPad = 16 / sizeof(T);  // row padding: 16 bytes
    int kp, xp, hp, cp;             // row pitches: weights (bf16), x, h and c tiles
    size_t w_bytes, bias_off, x_off, h_off, c_off, total;

    __host__ __device__ Layout(int uc, int fk, int hk, int rows) {
        kp = fk + hk + kPad;
        xp = fk + kPad;
        hp = hk + kPad;
        // bf16: (4 uc rows) x kp, gate-major for ldmatrix; float32: (fk + hk)
        // x uc x 4 gates, a float4 of the unit's four gates per depth
        w_bytes = sizeof(T) == 2 ? size_t(4) * uc * kp * 2 : size_t(fk + hk) * uc * 16;
        bias_off = w_bytes;
        x_off = bias_off + size_t(4) * uc * sizeof(float);
        h_off = x_off + size_t(rows) * xp * sizeof(T);              // one x tile
        c_off = h_off + size_t(2) * rows * hp * sizeof(T);          // two h tiles
        cp = uc + 4;  // c tile pitch: the rows of a lane group fall in other banks
        total = c_off + size_t(rows) * cp * sizeof(float);
    }
};

__device__ __forceinline__ void zero(Acc& acc) {
#pragma unroll
    for (int j = 0; j < kItemTiles; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[j][m][e] = 0.0f;
}

// One k16 step of an item's product: two m16 weight tiles (a0, a1: the
// unit group's (i, f) and (g, o) rows) against each 8-row n-tile of b.
__device__ __forceinline__ void mma_k16(const __nv_bfloat16* a0, const __nv_bfloat16* a1,
                                        const __nv_bfloat16* b, int pitch, int k, Acc& acc) {
    unsigned wa[4], wb[4];
    ldmatrix_x4(wa, a0 + k);
    ldmatrix_x4(wb, a1 + k);
#pragma unroll
    for (int j = 0; j < kItemTiles; ++j) {
        unsigned v[2];
        ldmatrix_x2(v, b + static_cast<size_t>(j * kTileN) * pitch + k);
        mma_bf16(acc[j][0], wa, v);
        mma_bf16(acc[j][1], wb, v);
    }
}

// out = src[the item's rows, 0 .. depth) . W[k0 .. k0 + depth, the unit
// group's gate columns], in the accumulator layout of two m16n8 tiles per
// n-tile: out[j][0] = (i, i, f, f), out[j][1] = (g, g, o, o) of unit
// g*8 + lane/4 and rows 2*(lane%4) + {0, 1} of n-tile j. bf16: on the tensor
// cores, two accumulator chains (even and odd k16 steps) at once.
__device__ __forceinline__ void product(const __nv_bfloat16* ws, const Layout<__nv_bfloat16>& L,
                                        int /*uc*/, int k0, const __nv_bfloat16* src, int pitch,
                                        int depth, int g, int r0, Acc& out) {
    const int lane = threadIdx.x & 31;
    // ldmatrix row addresses: A (16 x 16) by lanes 0..31, B (8 rows x 16) by 0..15
    const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
    const __nv_bfloat16* a0 = ws + static_cast<size_t>(g * 32 + a_row) * L.kp + k0 + (lane >> 4) * 8;
    const __nv_bfloat16* a1 = a0 + static_cast<size_t>(16) * L.kp;
    const __nv_bfloat16* b = src + static_cast<size_t>(r0 + (lane & 7)) * pitch + ((lane >> 3) & 1) * 8;
    Acc odd;
    zero(out);
    zero(odd);
    int k = 0;
#pragma unroll 2
    for (; k + 32 <= depth; k += 32) {
        mma_k16(a0, a1, b, pitch, k, out);
        mma_k16(a0, a1, b, pitch, k + 16, odd);
    }
    if (k < depth) mma_k16(a0, a1, b, pitch, k, out);
#pragma unroll
    for (int j = 0; j < kItemTiles; ++j)
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int e = 0; e < 4; ++e) out[j][m][e] += odd[j][m][e];
}

// float32: the same layout by FMA, each sum in depth order, four depths per
// step from float4 loads along k.
__device__ __forceinline__ void product(const float* ws, const Layout<float>& /*L*/, int uc,
                                        int k0, const float* src, int pitch, int depth, int g,
                                        int r0, Acc& out) {
    const int lane = threadIdx.x & 31;
    const float4* w4 = reinterpret_cast<const float4*>(ws) + static_cast<size_t>(k0) * uc + g * 8
                       + (lane >> 2);
    const float* row0 = src + static_cast<size_t>(r0 + 2 * (lane & 3)) * pitch;
    zero(out);
#pragma unroll 2
    for (int k = 0; k < depth; k += 4) {
        const float4 w[4] = {w4[static_cast<size_t>(k) * uc], w4[static_cast<size_t>(k + 1) * uc],
                             w4[static_cast<size_t>(k + 2) * uc], w4[static_cast<size_t>(k + 3) * uc]};
#pragma unroll
        for (int j = 0; j < kItemTiles; ++j) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float4 v = *reinterpret_cast<const float4*>(
                    row0 + static_cast<size_t>(j * kTileN + e) * pitch + k);
                const float vk[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
                for (int kk = 0; kk < 4; ++kk) {
                    out[j][0][e] = fmaf(vk[kk], w[kk].x, out[j][0][e]);
                    out[j][0][2 + e] = fmaf(vk[kk], w[kk].y, out[j][0][2 + e]);
                    out[j][1][e] = fmaf(vk[kk], w[kk].z, out[j][1][e]);
                    out[j][1][2 + e] = fmaf(vk[kk], w[kk].w, out[j][1][2 + e]);
                }
            }
        }
    }
}

// Stage x[row0 .. row0 + rows, t, :] into the tile xs: cp.async in 16-byte
// chunks where every row is such chunks, else plain loads.
template <typename T>
__device__ __forceinline__ void stage_x(const Params& p, const T* x, T* xs, int xp, int row0,
                                        int t) {
    if (p.x_async) {
        const int chunks = p.feat * static_cast<int>(sizeof(T)) / 16;
        constexpr int per = 16 / sizeof(T);
        for (int idx = threadIdx.x; idx < p.rows * chunks; idx += kThreads) {
            const int r = idx / chunks, q = idx - r * chunks;
            const int row = row0 + r;
            if (row < p.batch)
                cp_async16(xs + static_cast<size_t>(r) * xp + q * per,
                           x + (static_cast<size_t>(row) * p.t_len + t) * p.feat + q * per);
        }
        cp_async_commit();
    } else {
        for (int idx = threadIdx.x; idx < p.rows * p.feat; idx += kThreads) {
            const int r = idx / p.feat, k = idx - r * p.feat;
            const int row = row0 + r;
            xs[static_cast<size_t>(r) * xp + k] =
                row < p.batch ? x[(static_cast<size_t>(row) * p.t_len + t) * p.feat + k]
                              : from_float<T>(0.0f);
        }
    }
}

// Where the value of (depth k, gate, unit ul of this CTA) lives in the
// shared weights: bf16 rows per 8 units are 16 of (i, f) then 16 of (g, o),
// depth along the row; float32 is a float4 of the four gates per (k, unit).
template <typename T>
__device__ __forceinline__ size_t weight_index(const Layout<T>& L, int uc, int k, int gate, int ul) {
    if constexpr (sizeof(T) == 2) {
        const int row = (ul >> 3) * 32 + (gate >> 1) * 16 + (gate & 1) * 8 + (ul & 7);
        return static_cast<size_t>(row) * L.kp + k;
    } else {
        return (static_cast<size_t>(k) * uc + ul) * 4 + gate;
    }
}

// x.W of each of this warp's items from the staged tile xs, into xw.
template <typename T>
__device__ __forceinline__ void input_products(const T* ws, const Layout<T>& L, const Params& p,
                                               const T* xs, int items, int groups,
                                               Acc (&xw)[kMaxItems]) {
    const int warp = threadIdx.x >> 5;
#pragma unroll
    for (int s = 0; s < kMaxItems; ++s) {
        const int item = warp + s * kWarps;
        if (item < items)
            product(ws, L, p.uc, 0, xs, L.xp, p.fk, item % groups, (item / groups) * kItemRows,
                    xw[s]);
    }
}

// grid = (C, clusters per direction, 2), cluster = (C, 1, 1), kThreads threads.
template <typename T>
__global__ void __launch_bounds__(kThreads, 1) bilstm_stream_fwd_kernel(const Params p) {
    extern __shared__ __align__(16) unsigned char smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int n_ctas = static_cast<int>(cluster.num_blocks());
    const int rank = static_cast<int>(cluster.block_rank());
    const int dir = blockIdx.z;
    const int hidden = p.hidden, gates = 4 * hidden, uc = p.uc;
    const Layout<T> L(uc, p.fk, p.hk, p.rows);
    T* ws = reinterpret_cast<T*>(smem);
    float* bias = reinterpret_cast<float*>(smem + L.bias_off);
    T* xs = reinterpret_cast<T*>(smem + L.x_off);
    T* hbuf = reinterpret_cast<T*>(smem + L.h_off);
    float* cs = reinterpret_cast<float*>(smem + L.c_off);
    const T* x = static_cast<const T*>(p.x);
    T* h_out = static_cast<T*>(p.h_out);

    // zero everything: the padding of x, h and the weights must read 0
    for (size_t i = threadIdx.x; i < L.total / 16; i += kThreads)
        reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
    __syncthreads();

    // this CTA's columns of W and U (and b), once for the launch
    const T* wd = static_cast<const T*>(p.w) + static_cast<size_t>(dir) * p.feat * gates;
    const T* ud = static_cast<const T*>(p.u) + static_cast<size_t>(dir) * hidden * gates;
    if (p.vec) {
        // every unit of the CTA is real: 16-byte loads of `per` units' columns
        constexpr int per = 16 / sizeof(T);
        const int vecs = 4 * uc / per;
#pragma unroll 4
        for (int idx = threadIdx.x; idx < (p.feat + hidden) * vecs; idx += kThreads) {
            const int k = idx / vecs, q = idx - k * vecs;
            const int gate = q * per / uc, ul = q * per - gate * uc;
            const size_t col = static_cast<size_t>(gate) * hidden + rank * uc + ul;
            const int4 v = k < p.feat
                ? *reinterpret_cast<const int4*>(wd + static_cast<size_t>(k) * gates + col)
                : *reinterpret_cast<const int4*>(ud + static_cast<size_t>(k - p.feat) * gates + col);
            const T* e = reinterpret_cast<const T*>(&v);
            const int kk = k < p.feat ? k : p.fk + (k - p.feat);
#pragma unroll
            for (int i = 0; i < per; ++i) ws[weight_index(L, uc, kk, gate, ul + i)] = e[i];
        }
    } else {
        for (int idx = threadIdx.x; idx < (p.fk + p.hk) * 4 * uc; idx += kThreads) {
            const int k = idx / (4 * uc), m = idx - k * 4 * uc;
            const int gate = m / uc, ul = m - gate * uc;
            const int unit = rank * uc + ul;
            T v = from_float<T>(0.0f);
            if (unit < hidden) {
                const int col = gate * hidden + unit;
                if (k < p.fk) {
                    if (k < p.feat) v = wd[static_cast<size_t>(k) * gates + col];
                } else if (k - p.fk < hidden) {
                    v = ud[static_cast<size_t>(k - p.fk) * gates + col];
                }
            }
            ws[weight_index(L, uc, k, gate, ul)] = v;
        }
    }
    for (int m = threadIdx.x; m < 4 * uc; m += kThreads) {
        const int gate = m / uc, unit = rank * uc + (m - gate * uc);
        bias[m] = unit < hidden ? p.b[dir * gates + gate * hidden + unit] : 0.0f;
    }
    // every CTA's h tiles are zero before any peer writes into them
    cluster.sync();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int groups = uc / 8;
    const int items = groups * (p.rows / kItemRows);  // at most kMaxItems per warp
    const int out_pitch = 2 * hidden;
    int hb = 0;              // h tile parity, carried across row tiles
    Acc xw[kMaxItems];   // x_t.W of this warp's items, computed a step ahead

    for (int tile = blockIdx.y; tile < p.n_tiles; tile += gridDim.y) {
        const int row0 = tile * p.rows;
        stage_x<T>(p, x, xs, L.xp, row0, dir == 0 ? 0 : p.t_len - 1);
        cp_async_wait_all();
        __syncthreads();  // the tile's x_0 is staged
        input_products(ws, L, p, xs, items, groups, xw);
        __syncthreads();  // every warp is done with x_0
        for (int step = 0; step < p.t_len; ++step) {
            const int t = dir == 0 ? step : p.t_len - 1 - step;
            const T* hs = hbuf + static_cast<size_t>(hb) * p.rows * L.hp;
            T* hn = hbuf + static_cast<size_t>(hb ^ 1) * p.rows * L.hp;
            // x_{t+1} into the x tile, whose x_t every warp used last step
            // (before this CTA's barrier at the end of the last step)
            if (step + 1 < p.t_len) stage_x<T>(p, x, xs, L.xp, row0, dir == 0 ? t + 1 : t - 1);

            // the serial part: h.U, the gates and the cell update
#pragma unroll
            for (int s = 0; s < kMaxItems; ++s) {
                const int item = warp + s * kWarps;
                if (item >= items) continue;
                const int g = item % groups, r0 = (item / groups) * kItemRows;
                const int ul = g * 8 + (lane >> 2);
                Acc hu;
                if (step > 0)
                    product(ws, L, uc, p.fk, hs, L.hp, p.hk, g, r0, hu);
                else
                    zero(hu);
                const float b_i = bias[ul], b_f = bias[uc + ul];
                const float b_g = bias[2 * uc + ul], b_o = bias[3 * uc + ul];
#pragma unroll
                for (int j = 0; j < kItemTiles; ++j) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        // (x.W + b) + h.U, the plain version's order of the terms
                        const float a_i = (xw[s][j][0][e] + b_i) + hu[j][0][e];
                        const float a_f = (xw[s][j][0][2 + e] + b_f) + hu[j][0][2 + e];
                        const float a_g = (xw[s][j][1][e] + b_g) + hu[j][1][e];
                        const float a_o = (xw[s][j][1][2 + e] + b_o) + hu[j][1][2 + e];
                        const int r = r0 + j * kTileN + 2 * (lane & 3) + e;
                        float* c = cs + static_cast<size_t>(r) * L.cp + ul;
                        const float c_prev = step > 0 ? *c : 0.0f;
                        const float c_new =
                            gate_sigmoid<T>(a_f) * c_prev + gate_sigmoid<T>(a_i) * gate_tanh<T>(a_g);
                        *c = c_new;
                        hn[static_cast<size_t>(r) * L.hp + rank * uc + ul] =
                            from_float<T>(gate_sigmoid<T>(a_o) * gate_tanh<T>(c_new));
                    }
                }
            }
            __syncthreads();  // this CTA's slice of h and c is complete

            // the slice to every peer's h tile
            constexpr int per = 16 / sizeof(T);
            const int chunks = uc / per;
            if (step + 1 < p.t_len && n_ctas > 1) {
                for (int idx = threadIdx.x; idx < p.rows * chunks; idx += kThreads) {
                    const int r = idx / chunks, q = idx - r * chunks;
                    T* src = hn + static_cast<size_t>(r) * L.hp + rank * uc + q * per;
                    const int4 v = *reinterpret_cast<const int4*>(src);
                    for (int peer = 0; peer < n_ctas; ++peer)
                        if (peer != rank) *reinterpret_cast<int4*>(cluster.map_shared_rank(src, peer)) = v;
                }
            }
            // Split cluster barrier: arrive once this CTA's slice is out; then,
            // before waiting for the peers' slices, the work that needs none:
            // h_out and c_out of this step (after the arrive, so that its
            // release does not wait on them) and the next step's x.W.
            cluster_arrive();
            if (p.vec) {
                for (int idx = threadIdx.x; idx < p.rows * chunks; idx += kThreads) {
                    const int r = idx / chunks, q = idx - r * chunks;
                    const int row = row0 + r;
                    if (row < p.batch)
                        *reinterpret_cast<int4*>(h_out + (static_cast<size_t>(row) * p.t_len + t) * out_pitch
                                                 + dir * hidden + rank * uc + q * per) =
                            *reinterpret_cast<const int4*>(hn + static_cast<size_t>(r) * L.hp + rank * uc + q * per);
                }
                const int c_chunks = uc / 4;
                for (int idx = threadIdx.x; p.c_out != nullptr && idx < p.rows * c_chunks; idx += kThreads) {
                    const int r = idx / c_chunks, q = idx - r * c_chunks;
                    const int row = row0 + r;
                    if (row < p.batch)
                        *reinterpret_cast<float4*>(
                            p.c_out + (static_cast<size_t>(row) * p.t_len + t) * out_pitch
                            + dir * hidden + rank * uc + q * 4) =
                            *reinterpret_cast<const float4*>(cs + static_cast<size_t>(r) * L.cp + q * 4);
                }
            } else {
                for (int idx = threadIdx.x; idx < p.rows * uc; idx += kThreads) {
                    const int r = idx / uc, ul = idx - r * uc;
                    const int row = row0 + r, unit = rank * uc + ul;
                    if (row < p.batch && unit < hidden) {
                        const size_t o = (static_cast<size_t>(row) * p.t_len + t) * out_pitch
                                         + dir * hidden + unit;
                        h_out[o] = hn[static_cast<size_t>(r) * L.hp + unit];
                        if (p.c_out != nullptr) p.c_out[o] = cs[static_cast<size_t>(r) * L.cp + ul];
                    }
                }
            }
            if (step + 1 < p.t_len) {
                cp_async_wait_all();
                __syncthreads();  // x_{t+1} is staged
                input_products(ws, L, p, xs, items, groups, xw);
            }
            // the arrive let peers, and so this CTA's own warps, past the
            // barrier: none may start the next step (x staging, c and h
            // writes) until every warp is done reading here
            __syncthreads();
            cluster_wait();
            hb ^= 1;
        }
    }
}

int round_up(int v, int m) { return (v + m - 1) / m * m; }

struct Geometry {
    int uc, fk, hk, items;
    size_t smem;
};

template <typename T>
Geometry geometry(int feat, int hidden, int cluster, int rows) {
    Geometry g;
    g.uc = round_up((hidden + cluster - 1) / cluster, 8);
    g.fk = round_up(feat, 16);
    g.hk = round_up(cluster * g.uc, 16);
    g.items = g.uc / 8 * (rows / kItemRows);
    g.smem = Layout<T>(g.uc, g.fk, g.hk, rows).total;
    return g;
}

bool fits(const Geometry& g) {
    return g.smem <= kSmemLimit && g.items <= kMaxItems * kWarps;
}

// The kernel's launch configuration with `cluster` CTAs of `smem` bytes.
cudaLaunchConfig_t launch_config(int cluster, size_t smem, cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
    attr->id = cudaLaunchAttributeClusterDimension;
    attr->val.clusterDim.x = cluster;
    attr->val.clusterDim.y = 1;
    attr->val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    return cfg;
}

std::mutex g_mutex;
struct CachedClusters { int key[4]; int clusters; };
CachedClusters g_cache[64];
int g_cached = 0;

// Clusters of `cluster` CTAs with `smem` bytes each that the card holds at
// once, asked once per configuration.
template <typename T>
cudaError_t resident_clusters(int cluster, size_t smem, int device, int* resident) {
    const int key[4] = {static_cast<int>(sizeof(T)), cluster, static_cast<int>(smem), device};
    std::lock_guard<std::mutex> lock(g_mutex);
    for (int i = 0; i < g_cached; ++i)
        if (g_cache[i].key[0] == key[0] && g_cache[i].key[1] == key[1] &&
            g_cache[i].key[2] == key[2] && g_cache[i].key[3] == key[3]) {
            *resident = g_cache[i].clusters;
            return cudaSuccess;
        }
    auto kernel = bilstm_stream_fwd_kernel<T>;
    cudaError_t err = allow_dynamic_smem(kernel, kSmemLimit);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = launch_config(cluster, smem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (g_cached < 64) g_cache[g_cached++] = {{key[0], key[1], key[2], key[3]}, *resident};
    return cudaSuccess;
}

// The cluster size and rows per tile of the least cost, rounds of row tiles
// over the resident clusters times the cost of a step: two per item of a
// warp, one for the step's barriers, and half the cluster size for the
// exchange (fitted to the sweep of tools/torch_stream_fwd_sweep.py on an
// H100); ties go to the smaller cluster, then the smaller tile.
template <typename T>
cudaError_t choose(int batch, int feat, int hidden, int device, int* cluster, int* rows) {
    long best = -1;
    for (int c = 1; c <= kMaxCluster; c *= 2) {
        for (int r = kItemRows; r <= 64; r += kItemRows) {
            const Geometry g = geometry<T>(feat, hidden, c, r);
            if (!fits(g)) continue;
            int resident = 0;
            const cudaError_t err = resident_clusters<T>(c, g.smem, device, &resident);
            if (err != cudaSuccess) return err;
            if (resident < 2) continue;
            const long per_dir = resident / 2;
            const long rounds = ((batch + r - 1) / r + per_dir - 1) / per_dir;
            const long per_warp = (g.items + kWarps - 1) / kWarps;
            const long cost = rounds * (4 * per_warp + 2 + c);
            if (best < 0 || cost < best) {
                best = cost;
                *cluster = c;
                *rows = r;
            }
        }
    }
    return best < 0 ? cudaErrorInvalidValue : cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* u, const void* b, void* h_out,
                   void* c_out, int batch, int t_len, int feat, int hidden, int cluster, int rows,
                   cudaStream_t stream) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (cluster <= 0 || rows <= 0) {
        err = choose<T>(batch, feat, hidden, device, &cluster, &rows);
        if (err != cudaSuccess) return err;
    }
    if (cluster > kMaxCluster || rows <= 0 || rows % kItemRows != 0) return cudaErrorInvalidValue;
    const Geometry g = geometry<T>(feat, hidden, cluster, rows);
    if (!fits(g)) return cudaErrorInvalidValue;
    auto aligned = [](const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; };
    Params p{};
    p.x = x; p.w = w; p.u = u; p.b = static_cast<const float*>(b);
    p.h_out = h_out; p.c_out = static_cast<float*>(c_out);
    p.batch = batch; p.t_len = t_len; p.feat = feat; p.hidden = hidden;
    p.uc = g.uc;
    p.fk = g.fk;
    p.hk = g.hk;
    p.rows = rows;
    p.n_tiles = (batch + rows - 1) / rows;
    p.x_async = (feat * sizeof(T)) % 16 == 0 && aligned(x);
    p.vec = hidden == cluster * g.uc && aligned(w) && aligned(u) && aligned(h_out) &&
            aligned(c_out);
    int resident = 0;
    err = resident_clusters<T>(cluster, g.smem, device, &resident);
    if (err == cudaSuccess) err = allow_dynamic_smem(bilstm_stream_fwd_kernel<T>, kSmemLimit);
    if (err != cudaSuccess) return err;
    const int per_dir = resident / 2 > 0 ? resident / 2 : 1;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = launch_config(cluster, g.smem, stream, &attr);
    cfg.gridDim = dim3(cluster, p.n_tiles < per_dir ? p.n_tiles : per_dir, 2);
    err = cudaLaunchKernelEx(&cfg, bilstm_stream_fwd_kernel<T>, p);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. is_bf16 selects the element type of x, w,
// u and h_out (0: float32, 1: bfloat16). c_out may be null. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() as an int
// (cudaErrorInvalidValue when the weights fit no cluster's shared memory).
extern "C" int clair_bilstm_stream_fwd(const void* x, const void* w, const void* u,
                                       const void* b, void* h_out, void* c_out,
                                       int batch, int t_len, int feat, int hidden,
                                       int is_bf16, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? launch<__nv_bfloat16>(x, w, u, b, h_out, c_out, batch, t_len, feat, hidden, 0, 0, s)
        : launch<float>(x, w, u, b, h_out, c_out, batch, t_len, feat, hidden, 0, 0, s);
    return static_cast<int>(err);
}

// The same with the cluster size and rows per tile given (0: chosen as
// above), for sweeping the geometry; when `chosen` is not null, four ints
// come back through it: the cluster size, the rows per tile, the clusters
// the card holds at once and the clusters launched per direction.
extern "C" int clair_bilstm_stream_fwd_geometry(const void* x, const void* w, const void* u,
                                                const void* b, void* h_out, void* c_out,
                                                int batch, int t_len, int feat, int hidden,
                                                int is_bf16, int cluster, int rows, int* chosen,
                                                void* stream) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err == cudaSuccess && (cluster <= 0 || rows <= 0))
        err = is_bf16 ? choose<__nv_bfloat16>(batch, feat, hidden, device, &cluster, &rows)
                      : choose<float>(batch, feat, hidden, device, &cluster, &rows);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (chosen != nullptr) {
        chosen[0] = cluster;
        chosen[1] = rows;
        const size_t smem = is_bf16 ? geometry<__nv_bfloat16>(feat, hidden, cluster, rows).smem
                                    : geometry<float>(feat, hidden, cluster, rows).smem;
        err = is_bf16 ? resident_clusters<__nv_bfloat16>(cluster, smem, device, &chosen[2])
                      : resident_clusters<float>(cluster, smem, device, &chosen[2]);
        if (err != cudaSuccess) return static_cast<int>(err);
        const int tiles = (batch + rows - 1) / rows, per_dir = chosen[2] / 2 > 0 ? chosen[2] / 2 : 1;
        chosen[3] = tiles < per_dir ? tiles : per_dir;
    }
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    err = is_bf16
        ? launch<__nv_bfloat16>(x, w, u, b, h_out, c_out, batch, t_len, feat, hidden, cluster, rows, s)
        : launch<float>(x, w, u, b, h_out, c_out, batch, t_len, feat, hidden, cluster, rows, s);
    return static_cast<int>(err);
}
