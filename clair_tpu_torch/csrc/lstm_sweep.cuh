// The float32 forward sweep of one bidirectional LSTM layer on the tensor
// cores, for Hopper (sm_90a): h (and c) of every step from every step's
// input pre-activations xw = x.W + b, which a tensor-core product computes
// for all steps at once beforehand (mma_product.cuh). Only h.U is serial.
// Rows 5 and 4 of the port's kernel table run on it: the resident training
// forward (bilstm_train.cu, for clair_tpu/ops/pallas_bilstm_train.py:
// _fwd_kernel) and the two-layer forward (ops/bilstm2.py, for
// clair_tpu/ops/pallas_bilstm2.py:_bilstm2_kernel).
//
// What bounds it: a step's product is small (rows x H x 4H) and the T steps
// are serial, so the weights must stay on chip and a step's latency (the
// carry, the cell, the exchange of h, one cluster barrier) sets the time.
// The design before this one (one thread per hidden unit, float32 FMA)
// re-read W and U from L2 every step for 4 or 16 rows. Keeping float32 U on
// chip does not help by itself: the streaming forward's float32 mode does
// so and is bound by the shared-memory loads that feed its FMAs.
//
// Design:
// - Numerics: h.U as three bf16 pieces of each operand (p0 = bf16(v),
//   p1 = bf16(v - p0), p2 = bf16(v - p0 - p1)) on mma.sync m16n8k16, the
//   six piece pairs i + j < 3, float32 sums: float32-level products
//   (|v - sum of pieces| <= 2^-24 |v|; mma_product.cuh, "Numerics"). The
//   pair (0, 0) sums apart from the five smaller ones. The cell runs in
//   float32 with the accurate tanhf (sigmoid through it); h and c go out
//   in float32.
// - A thread-block cluster of C CTAs (C in {2, 4, 8}) runs one (row tile,
//   direction). Each CTA owns uc = H/C hidden units (rounded up to 8; units
//   past H are zero and stay zero) and keeps U's three pieces for the four
//   gate columns of its units in shared memory for the whole launch (384 KB
//   / C at H = 128), gate-major as the streaming forward keeps its bf16
//   weights: per 8 units, 8 rows each of i, f, g, o, so one ldmatrix tile
//   pair gives a lane all four gates of one unit. Rows of 16-byte chunks
//   are XOR-swizzled, so ldmatrix reads them without bank conflicts.
// - The CTA that computes its units' new h splits it into three pieces and
//   stores them into its own double-buffered h tile, then, 16 bytes at a
//   time, into every peer's through distributed shared memory; one split
//   cluster barrier a step orders the exchange. h_out and c_out of the
//   step go out from registers between the barrier's arrive and its wait.
// - A warp takes items of 8 units by 8 or 16 rows; a lane owns one unit
//   and two rows of each 8-row n-tile (the accumulator layout), and keeps
//   their c and the xw of its cells in registers. Each lane loads the next
//   step's xw as soon as its cells have used this step's, so the loads
//   land during the exchange, the barrier and the next step's product. A
//   warp's two items share one unit group where the groups divide the
//   warps, and then one product, so U's fragments load once for both.
// - The grid is persistent: C x min(row tiles, resident clusters / 2) x 2
//   directions, each cluster walking its direction's row tiles, so U
//   loads once per CTA.
// - The launcher picks C and the rows per tile (a multiple of 8) by a cost:
//   rounds of row tiles over the clusters the card holds at once
//   (cudaOccupancyMaxActiveClusters, asked once per configuration) times a
//   step's cost, which grows with the n-tiles a warp carries.
//   ops/bilstm_train.py keeps the same carve-up arithmetic (SweepGeometry)
//   and raises before a launch where no geometry fits.
//
// Measured on an H100 80GB HBM3 at 700 W (tools/torch_train_fwd_sweep.py,
// row 5's forward of one layer, all three parts, B = 10,000, F = 32 / 256):
// 4.08 / 7.24 ms at the launcher's geometry, a cluster of 2 and 16 rows a
// tile, the fastest of the 19 that launch (PERF.md has the table); the
// sweep is 2.81 / 2.84 ms of it (chip_smoke.py phase 9a). What a part costs (the forward without it):
// h.U 1.31 / 1.38 ms, a step's float32 cell 0.28 / 0.38, the next step's
// xw loads 0.31 / 0.45, the exchange of h 0.23 / 0.27, h_out and c_out
// 0.19 / 0.26; sigmoid as 1 / (1 + expf(-v)) adds 0.32 / 0.17. h.U runs
// near mma.sync's rate for six passes; the cost per step is mostly serial.
//
// The layout policy S (bilstm_train.cu: StackedForward) supplies xw (rows
// of 4H float32), u ((2, H, 4H) float32), h_out and c_out (float32, c_out
// may be null), batch, t_len and hidden, and
//   xw_row(dir, r, step)  the row of (direction, row, step) in xw;
//   out_at(dir, r, step)  the offset of its unit 0 in h_out and c_out.
// Step 0 of each direction starts from h = c = 0.
#pragma once

#include <cooperative_groups.h>

#include <mutex>

#include "mma_product.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kSweepWarps = kThreads / 32;
constexpr int kSweepMaxItems = 2;    // warp items per warp
constexpr int kSweepMaxRows = 128;   // rows per tile the launcher considers
// the cost model of the launcher's choice, a step's time in two parts: a
// fixed one (barriers, exchange) and one per 8-row n-tile that a warp
// carries (its product and cells), in the ratio 1 : 2 that fits the times
// of every geometry (tools/torch_train_fwd_sweep.py, PERF.md)
constexpr long kStepCost = 1, kTileCost = 2;

// One CTA's geometry and the carve-up of its shared memory, bytes.
struct SweepGeometry {
    int cluster, rows;
    int uc;          // units per CTA, a multiple of 8
    int hk;          // the depth of h.U, C * uc (a multiple of 16)
    int item_tiles;  // 8-row n-tiles per warp item: 2 where rows allow
    int items;       // warp items a step (item i is warp i % 8's)
    int joint;       // a warp's items in one product: 2 where they share a unit group
    size_t h_off, smem;
    __host__ __device__ SweepGeometry(int hidden, int cluster_, int rows_)
        : cluster(cluster_), rows(rows_) {
        uc = ((hidden + cluster - 1) / cluster + 7) / 8 * 8;
        hk = cluster * uc;
        item_tiles = rows % 16 == 0 ? 2 : 1;
        const int groups = uc / 8;
        items = groups * (rows / (8 * item_tiles));
        joint = items > kSweepWarps && kSweepWarps % groups == 0 ? 2 : 1;
        h_off = size_t(3) * 4 * uc * hk * sizeof(bf16);             // U: 3 pieces, 4 uc rows
        smem = h_off + size_t(2) * 3 * rows * hk * sizeof(bf16);    // h: 2 tiles of 3 pieces
    }
    __host__ __device__ bool fits() const {
        return (cluster == 2 || cluster == 4 || cluster == 8) && rows > 0 && rows % 8 == 0 &&
               smem <= kSmemLimit && items <= kSweepMaxItems * kSweepWarps;
    }
};

// sigmoid(v) = (1 + tanh(v / 2)) / 2 with the accurate tanhf. It has no
// division: 1 / (1 + expf(-v)) takes IEEE division's slow-path branch,
// which keeps a lane's cells from interleaving (tools/
// torch_train_fwd_sweep.py times both; PERF.md has the numbers).
__device__ __forceinline__ float sigmoid_tanh(float v) { return fmaf(0.5f, tanhf(0.5f * v), 0.5f); }

// The XOR swizzle of a bf16 tile whose rows are hk values: the 16-byte
// chunk q of row r lives at chunk q ^ (r & mask).
__host__ __device__ inline int swizzle_mask(int hk) {
    const int chunks = hk / 8, low = chunks & -chunks;
    return (low < 8 ? low : 8) - 1;
}
__device__ __forceinline__ int swizzled(int row, int k, int hk, int mask) {
    return row * hk + (((k >> 3) ^ (row & mask)) << 3) + (k & 7);
}

// acc[i] += h[rows r0[i] ..] . U[the unit group's gate columns] over the
// depth hk for NI items of one unit group, three pieces each, in the
// accumulator layout of two m16 tiles (the (i, f) and (g, o) rows of 8
// units) per 8-row n-tile j: acc[i][j][0] = (i, i, f, f), acc[i][j][1] =
// (g, g, o, o) of the lane's unit and rows 2 * (lane % 4) + {0, 1}. The
// items share U's fragments.
template <int J, int NI>
__device__ __forceinline__ void carry_product(const bf16* us, const bf16* hs, const SweepGeometry& g,
                                              int mask, int grp, const int (&r0)[NI],
                                              float (&acc)[NI][J][2][4]) {
    const int lane = threadIdx.x & 31;
    const size_t u_piece = size_t(4) * g.uc * g.hk, h_piece = size_t(g.rows) * g.hk;
    // ldmatrix row addresses: A (16 x 16) by lanes 0..31; B (8 rows x 16),
    // two n-tiles by lanes 0..31 or one by lanes 0..15
    const int a_row = grp * 32 + (lane & 7) + ((lane >> 3) & 1) * 8, a_half = (lane >> 4) * 8;
    const int b_half = ((lane >> 3) & 1) * 8;
    int b_row[NI];
#pragma unroll
    for (int i = 0; i < NI; ++i) b_row[i] = r0[i] + (lane & 7) + (J == 2 ? ((lane >> 4) & 1) * 8 : 0);
    // the five smaller pairs apart from the pair (0, 0); with one item,
    // alternately into two sums (mma.sync issues in program order: other
    // sums' products lie between two that add to the same one)
    constexpr int kLo = NI == 1 ? 2 : 1;
    float lo[kLo][NI][J][2][4];
#pragma unroll
    for (int q = 0; q < kLo; ++q)
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e) lo[q][i][j][m][e] = 0.0f;
    // one pass: the piece pair (pa, pb) for every item, n-tile and m16 tile
    auto pass = [](float (&d)[NI][J][2][4], const unsigned (&pa)[2][4],
                   const unsigned (&pb)[NI][J][2]) {
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
                for (int m = 0; m < 2; ++m) mma_bf16(d[i][j][m], pa[m], pb[i][j]);
    };
#pragma unroll 2
    for (int k = 0; k < g.hk; k += 16) {
        // U's three pieces of both m16 tiles, h's of every item's n-tiles
        unsigned a[3][2][4], b[3][NI][J][2];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
#pragma unroll
            for (int m = 0; m < 2; ++m)
                ldmatrix_x4(a[p][m], us + p * u_piece + swizzled(a_row + m * 16, k + a_half, g.hk, mask));
#pragma unroll
            for (int i = 0; i < NI; ++i) {
                const bf16* hp = hs + p * h_piece + swizzled(b_row[i], k + b_half, g.hk, mask);
                if constexpr (J == 2) {
                    unsigned v[4];
                    ldmatrix_x4(v, hp);
                    b[p][i][0][0] = v[0];
                    b[p][i][0][1] = v[1];
                    b[p][i][1][0] = v[2];
                    b[p][i][1][1] = v[3];
                } else {
                    ldmatrix_x2(b[p][i][0], hp);
                }
            }
        }
        pass(acc, a[0], b[0]);
        pass(lo[0], a[0], b[1]);
        pass(lo[kLo - 1], a[1], b[0]);
        pass(lo[0], a[0], b[2]);
        pass(lo[kLo - 1], a[1], b[1]);
        pass(lo[0], a[2], b[0]);
    }
#pragma unroll
    for (int q = 0; q < kLo; ++q)
#pragma unroll
        for (int i = 0; i < NI; ++i)
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
                for (int m = 0; m < 2; ++m)
#pragma unroll
                    for (int e = 0; e < 4; ++e) acc[i][j][m][e] += lo[q][i][j][m][e];
}

// grid = (C, clusters per direction, 2), cluster = (C, 1, 1), kThreads
// threads, g.smem bytes of dynamic shared memory; J = g.item_tiles,
// NI = g.joint.
template <class S, int J, int NI>
__global__ void __launch_bounds__(kThreads, 1) lstm_fwd_sweep(const S s, const SweepGeometry g,
                                                              int n_tiles) {
    // (named apart from the including file's kernels)
    extern __shared__ __align__(16) unsigned char fwd_sweep_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int dir = blockIdx.z;
    const int hidden = s.hidden, gates = 4 * hidden, uc = g.uc, hk = g.hk, rows = g.rows;
    const int mask = swizzle_mask(hk);
    bf16* us = reinterpret_cast<bf16*>(fwd_sweep_smem);
    bf16* hbuf = reinterpret_cast<bf16*>(fwd_sweep_smem + g.h_off);
    const size_t u_piece = size_t(4) * uc * hk, h_piece = size_t(rows) * hk;

    // U's columns of this CTA's units as three pieces, once for the launch
    const float* ud = s.u + static_cast<size_t>(dir) * hidden * gates;
    for (int idx = threadIdx.x; idx < hk * 4 * uc; idx += kThreads) {
        const int k = idx / (4 * uc), m = idx - k * 4 * uc;
        const int gate = m / uc, ul = m - gate * uc, unit = rank * uc + ul;
        float rest = k < hidden && unit < hidden
            ? ud[static_cast<size_t>(k) * gates + gate * hidden + unit] : 0.0f;
        const int at = swizzled((ul >> 3) * 32 + gate * 8 + (ul & 7), k, hk, mask);
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            const bf16 piece = __float2bfloat16_rn(rest);
            us[p * u_piece + at] = piece;
            rest -= __bfloat162float(piece);
        }
    }
    // U is in place, and every CTA runs before any peer writes into it
    cluster.sync();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tq = lane & 3;
    const int groups = uc / 8;
    auto item_of = [&](int slot) { return warp + slot * kSweepWarps; };
    // the lane's unit of an item (or past H), and its first row in the tile
    auto unit_of = [&](int item) { return rank * uc + (item % groups) * 8 + gid; };
    auto row_of = [&](int item) { return (item / groups) * 8 * J; };
    // xw of the lane's cells (item slot, n-tile, row, gate), loaded a step
    // ahead into registers
    float xv[kSweepMaxItems][J][2][4];
    auto load_xw = [&](int row0, int step) {
#pragma unroll
        for (int sl = 0; sl < kSweepMaxItems; ++sl) {
            const int item = item_of(sl);
            if (item >= g.items) continue;
            const int unit = unit_of(item);
#pragma unroll
            for (int j = 0; j < J; ++j)
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                    const int row = row0 + row_of(item) + j * 8 + 2 * tq + e;
                    const bool real = row < s.batch && unit < hidden;
                    const float* src = s.xw + (real ? s.xw_row(dir, row, step) * gates + unit : 0);
#pragma unroll
                    for (int q = 0; q < 4; ++q) xv[sl][j][e][q] = real ? src[q * hidden] : 0.0f;
                }
        }
    };

    int hb = 0;  // h tile parity, carried across row tiles
    for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
        const int row0 = tile * rows;
        load_xw(row0, 0);
        float c[kSweepMaxItems][J][2];
#pragma unroll
        for (int sl = 0; sl < kSweepMaxItems; ++sl)
#pragma unroll
            for (int j = 0; j < J; ++j) c[sl][j][0] = c[sl][j][1] = 0.0f;

        for (int step = 0; step < s.t_len; ++step) {
            const bf16* hs = hbuf + static_cast<size_t>(hb) * 3 * h_piece;
            bf16* hn = hbuf + static_cast<size_t>(hb ^ 1) * 3 * h_piece;
            // h.U of the lane's cells: item slot sl in acc[sl / NI][sl % NI]
            float acc[kSweepMaxItems / NI][NI][J][2][4];
#pragma unroll
            for (int q = 0; q < kSweepMaxItems / NI; ++q)
#pragma unroll
                for (int i = 0; i < NI; ++i)
#pragma unroll
                    for (int j = 0; j < J; ++j)
#pragma unroll
                        for (int m = 0; m < 2; ++m)
#pragma unroll
                            for (int e = 0; e < 4; ++e) acc[q][i][j][m][e] = 0.0f;
            // h.U for every item of the warp, NI items of one unit group to
            // a product (h_{-1} = 0: none at step 0)
#pragma unroll
            for (int s0 = 0; s0 < kSweepMaxItems; s0 += NI) {
                if (step == 0 || item_of(s0) >= g.items) continue;  // later slots are empty
                int r0[NI];  // an empty slot repeats the first (its result unused)
#pragma unroll
                for (int i = 0; i < NI; ++i)
                    r0[i] = row_of(item_of(s0 + i) < g.items ? item_of(s0 + i) : item_of(s0));
                carry_product<J, NI>(us, hs, g, mask, item_of(s0) % groups, r0, acc[s0 / NI]);
            }

            float hv[kSweepMaxItems][J][2];
#pragma unroll
            for (int sl = 0; sl < kSweepMaxItems; ++sl) {
                const int item = item_of(sl);
                if (item >= g.items) continue;
                const int unit = unit_of(item), r0 = row_of(item);
#pragma unroll
                for (int j = 0; j < J; ++j) {
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        // (x.W + b) + h.U, the plain version's order of the terms
                        const float(&hu)[2][4] = acc[sl / NI][sl % NI][j];
                        const float a_i = xv[sl][j][e][0] + hu[0][e];
                        const float a_f = xv[sl][j][e][1] + hu[0][2 + e];
                        const float a_g = xv[sl][j][e][2] + hu[1][e];
                        const float a_o = xv[sl][j][e][3] + hu[1][2 + e];
                        c[sl][j][e] = sigmoid_tanh(a_f) * c[sl][j][e] + sigmoid_tanh(a_i) * tanhf(a_g);
                        const float h = sigmoid_tanh(a_o) * tanhf(c[sl][j][e]);
                        hv[sl][j][e] = h;
                        float rest = h;
                        bf16* out = hn + swizzled(r0 + j * 8 + 2 * tq + e, unit, hk, mask);
#pragma unroll
                        for (int p = 0; p < 3; ++p) {
                            const bf16 piece = __float2bfloat16_rn(rest);
                            out[p * h_piece] = piece;
                            rest -= __bfloat162float(piece);
                        }
                    }
                }
            }
            __syncthreads();  // this CTA's slice of h is complete; hs is read

            if (step + 1 < s.t_len) {
                // the next step's xw, in flight during the exchange, the
                // barrier and the next step's product
                load_xw(row0, step + 1);
                // the slice to every peer's h tile, 16 bytes at a time
                const int chunks = uc / 8, first = rank * uc / 8;
                for (int peer = 1; peer < g.cluster; ++peer) {
                    bf16* dst = cluster.map_shared_rank(hn, (rank + peer) % g.cluster);
                    for (int idx = threadIdx.x; idx < 3 * rows * chunks; idx += kThreads) {
                        const int pr = idx / chunks;  // piece * rows + row
                        const int q = first + idx - pr * chunks, r = pr % rows;
                        const size_t at = static_cast<size_t>(pr) * hk + ((q ^ (r & mask)) << 3);
                        *reinterpret_cast<int4*>(dst + at) = *reinterpret_cast<const int4*>(hn + at);
                    }
                }
            }
            // Split cluster barrier: arrive once the slice is out; before
            // waiting for the peers' slices, this step's h_out and c_out
            // (after the arrive, so that its release waits on no global
            // store). A warp past the wait reads only h tiles that every
            // CTA has finished, and writes only the one every warp read
            // last step.
            cluster_arrive();
#pragma unroll
            for (int sl = 0; sl < kSweepMaxItems; ++sl) {
                const int item = item_of(sl);
                if (item >= g.items) continue;
                const int unit = unit_of(item);
#pragma unroll
                for (int j = 0; j < J; ++j)
#pragma unroll
                    for (int e = 0; e < 2; ++e) {
                        const int row = row0 + row_of(item) + j * 8 + 2 * tq + e;
                        if (row < s.batch && unit < hidden) {
                            const size_t o = s.out_at(dir, row, step) + unit;
                            s.h_out[o] = hv[sl][j][e];
                            if (s.c_out != nullptr) s.c_out[o] = c[sl][j][e];
                        }
                    }
            }
            cluster_wait();
            hb ^= 1;
        }
    }
}

// The sweep's launch configuration: clusters of `cluster` CTAs of `smem` bytes.
cudaLaunchConfig_t sweep_config(int cluster, size_t smem, cudaStream_t stream,
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

std::mutex g_sweep_mutex;
struct SweepResident { const void* kernel; int cluster; size_t smem; int device, clusters; };
SweepResident g_sweep_resident[64];
int g_sweep_cached = 0;

// The kernel of a geometry's item shape.
template <class S>
auto sweep_kernel(const SweepGeometry& g) -> void (*)(S, SweepGeometry, int) {
    if (g.item_tiles == 2) return g.joint == 2 ? lstm_fwd_sweep<S, 2, 2> : lstm_fwd_sweep<S, 2, 1>;
    return g.joint == 2 ? lstm_fwd_sweep<S, 1, 2> : lstm_fwd_sweep<S, 1, 1>;
}

// Clusters of the geometry's kernel that the card holds at once, asked once
// per configuration.
template <class S>
cudaError_t sweep_resident(const SweepGeometry& g, int device, int* resident) {
    const auto kernel = sweep_kernel<S>(g);
    const void* key = reinterpret_cast<const void*>(kernel);
    std::lock_guard<std::mutex> lock(g_sweep_mutex);
    for (int i = 0; i < g_sweep_cached; ++i) {
        const SweepResident& e = g_sweep_resident[i];
        if (e.kernel == key && e.cluster == g.cluster && e.smem == g.smem && e.device == device) {
            *resident = e.clusters;
            return cudaSuccess;
        }
    }
    cudaError_t err = allow_dynamic_smem(kernel, kSmemLimit);
    if (err != cudaSuccess) return err;
    cudaLaunchAttribute attr;
    const cudaLaunchConfig_t cfg = sweep_config(g.cluster, g.smem, nullptr, &attr);
    err = cudaOccupancyMaxActiveClusters(resident, kernel, &cfg);
    if (err != cudaSuccess) return err;
    if (g_sweep_cached < 64)
        g_sweep_resident[g_sweep_cached++] = {key, g.cluster, g.smem, device, *resident};
    return cudaSuccess;
}

// The sweep's geometry: the given (cluster, rows), or where either is 0 the
// one of least cost (ties to the smaller cluster, then the smaller tile);
// cudaErrorInvalidValue where the given one does not fit or the card holds
// fewer than two of its clusters at once. `chosen`, unless null, gets the
// cluster size, the rows per tile, the clusters the card holds at once and
// the clusters launched per direction.
template <class S>
cudaError_t plan_fwd_sweep(int batch, int hidden, int& cluster, int& rows, int& per_dir,
                           int* chosen) {
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return err;
    if (cluster <= 0 || rows <= 0) {
        long best = -1;
        for (int c = 2; c <= 8; c *= 2) {
            for (int r = 8; r <= kSweepMaxRows; r += 8) {
                const SweepGeometry g(hidden, c, r);
                if (!g.fits()) continue;
                int resident = 0;
                err = sweep_resident<S>(g, device, &resident);
                if (err != cudaSuccess) return err;
                if (resident < 2) continue;
                const long tiles = (batch + r - 1) / r, clusters = resident / 2;
                const long rounds = (tiles + clusters - 1) / clusters;
                const long per_warp = (g.items + kSweepWarps - 1) / kSweepWarps * g.item_tiles;
                const long cost = rounds * (kTileCost * per_warp + kStepCost);
                if (best < 0 || cost < best) {
                    best = cost;
                    cluster = c;
                    rows = r;
                }
            }
        }
        if (best < 0) return cudaErrorInvalidValue;
    }
    const SweepGeometry g(hidden, cluster, rows);
    if (!g.fits()) return cudaErrorInvalidValue;
    int resident = 0;
    err = sweep_resident<S>(g, device, &resident);
    if (err != cudaSuccess) return err;
    if (resident < 2) return cudaErrorInvalidValue;
    const int tiles = (batch + rows - 1) / rows;
    per_dir = tiles < resident / 2 ? tiles : resident / 2;
    if (chosen != nullptr) {
        chosen[0] = cluster;
        chosen[1] = rows;
        chosen[2] = resident;
        chosen[3] = per_dir;
    }
    return cudaSuccess;
}

// Launch the sweep of policy s at a geometry from plan_fwd_sweep.
template <class S>
cudaError_t launch_fwd_sweep(const S& s, int cluster, int rows, int per_dir, cudaStream_t stream) {
    const SweepGeometry g(s.hidden, cluster, rows);
    const int tiles = (s.batch + rows - 1) / rows;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = sweep_config(cluster, g.smem, stream, &attr);
    cfg.gridDim = dim3(cluster, per_dir, 2);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, sweep_kernel<S>(g), s, g, tiles);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace
