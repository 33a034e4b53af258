// The float32 reverse sweep of a bidirectional LSTM layer's backward on the
// tensor cores, for Hopper (sm_90a): part (b) of the streaming backward's
// float32 mode (row 2, bilstm_stream_bwd.cu, for
// clair_tpu/ops/pallas_bilstm_stream.py:_bwd_kernel, its carry at :113-135)
// and of the resident training backward (row 6, bilstm_train.cu, for
// clair_tpu/ops/pallas_bilstm_train.py:_bwd_kernel). Over t in reverse, from
// the gate pre-activations that part (a) wrote for every step at once:
//   dh = dh_out_t + dh_carry, dc = dc_carry + dh*o*(1 - tanh^2 c),
//   dgates = [dc*g*i(1-i), dc*c_prev*f(1-f), dc*i(1-g^2), dh*tanh(c)*o(1-o)],
//   dh_carry = dgates . U^T, dc_carry = dc*f,
// each entry's dgates written as three bf16 pieces for the weight sums and
// dx (parts (c) and (d)).
//
// What bounds it: as in the forward sweep (lstm_sweep.cuh), the T steps are
// serial and a step's product is small (rows x 4H x H), so U must stay on
// chip and a step's latency sets the time; and bytes: a unit-step reads 16 B
// of gates and 12 B of c, c_prev and dh_out and writes 24 B of pieces, ~4.4
// GB a layer at B = 10,000 (1.3 ms at 3.35 TB/s). The design before this
// one (one thread per unit, float32 FMA, U^T streamed from L2 through shared
// memory every step for 4 or 8 rows) took 5.26-5.44 ms a layer there.
//
// Design, the forward sweep's parts run in reverse:
// - A thread-block cluster of C CTAs (C in {2, 4, 8}) runs one (row tile,
//   direction); the grid is persistent, each cluster walking its direction's
//   row tiles, so U loads once per CTA. CTA c owns uc = H/C units (rounded
//   up to 8) and holds U's three bf16 pieces for its units' four gate
//   columns over all H rows: the forward's tile (load_u_pieces), gate-major
//   and XOR-swizzled (3 x 128 KB / C at H = 128).
// - The carry is split along its reduction, not its output: CTA c computes
//   for every unit j the partial sum over its own 4uc gate columns q,
//   partial_c[r][j] = sum_q dgates[r][q] * U[j][q], on mma.sync m16n8k16
//   with j along M (U's tile the A operand; its rows run along the
//   reduction, so ldmatrix.trans reads it) and the rows along N (the step's
//   dgates of its own cells, three bf16 pieces in shared memory, the B
//   operand). The dgates never leave the CTA.
// - Reduce-scatter through distributed shared memory: CTA c writes
//   partial_c[:, units of c'] (float32, rows x uc) into c''s receive slot c;
//   each CTA then sums its C slots in rank order 0 .. C-1 into dh_carry of
//   its own units: a fixed order and no atomics, the same bits every run.
// - Numerics: dgates and U as three bf16 pieces each (mma_product.cuh,
//   "Numerics"), the six piece pairs i + j < 3 with float32 sums, the pair
//   (0, 0) in an accumulator apart from the five smaller ones (one float32
//   accumulator over many mma steps cuts toward zero; PERF.md §6). The
//   cell runs in float32 with the accurate tanhf (cell_backward<float>).
// - Two phases of the split cluster barrier a step, so the slots need no
//   second buffer: each CTA arrives once its cells have read their slots,
//   and waits on that phase only before its first remote write, after its
//   product; and arrives again once its partial sums are out, waiting on
//   that phase before the next step's cells read them.
// - A thread takes (row, 4 units) cells ("quads"). It loads the next step's
//   gates, c_prev and dh_out into registers once this step's are used, so
//   the loads land during the product and the barrier, and it copies its
//   own cells' pieces from the shared tile to device memory between the
//   second phase's arrive and its wait (the tile is rewritten only by the
//   same thread, after the wait).
// - The launcher picks (C, rows) by the forward's cost (plan_sweep) over the
//   clusters the card holds at once (cudaOccupancyMaxActiveClusters, asked
//   once per configuration); ops/lstm_sweep.py keeps the same carve-up
//   arithmetic (bwd_sweep_layout) and raises before a launch where no
//   geometry fits.
//
// The layout policy S (bilstm_stream_bwd.cu: SweepArgs; bilstm_train.cu:
// StackedSweep) supplies gates (float32 pre-activations, a row of 4H per
// (direction, row, step)), pieces (the dgates out, three bf16 rows of 4H per
// entry), c_out and dh_out (float32), u ((2, H, 4H) float32), batch (rows
// per direction), t_len and hidden, and
//   time(dir, step)  the step's time index;
//   row(dir, r, t)   the entry's row in gates and pieces;
//   cell(dir, r, t)  the offset of unit 0 of the entry in c_out and dh_out;
//   prev(dir, t)     the time index of c_prev, or -1 at the sequence edge
//                    (the zero initial state).
#pragma once

#include "lstm_sweep.cuh"

namespace {

constexpr int kBwdMaxQuads = 2;  // (row, 4 units) cells a thread

// One CTA's geometry and the carve-up of its shared memory, bytes.
struct BwdSweepGeometry {
    int cluster, rows;
    int uc;          // units per CTA, a multiple of 8
    int hk;          // C * uc: the carry's outputs j (a multiple of 16)
    int item_tiles;  // 8-row n-tiles per warp item: 4, 2 or 1
    int items;       // warp items a step: (m16 tile of j, item_tiles n-tiles)
    int quads;       // (row, 4 units) cells a step
    int pitch;       // floats a row of a receive slot (bank-conflict free)
    size_t dg_off, slot_off, smem;
    __host__ __device__ BwdSweepGeometry(int hidden, int cluster_, int rows_)
        : cluster(cluster_), rows(rows_) {
        uc = ((hidden + cluster - 1) / cluster + 7) / 8 * 8;
        hk = cluster * uc;
        const int m_tiles = hk / 16, n_tiles = rows / 8;
        // the most n-tiles an item that still gives every warp one
        item_tiles = 1;
        for (int nj = 4; nj > 1; nj /= 2) {
            if (n_tiles % nj == 0 && m_tiles * (n_tiles / nj) >= kSweepWarps) {
                item_tiles = nj;
                break;
            }
        }
        items = m_tiles * (n_tiles / item_tiles);
        quads = rows * uc / 4;
        pitch = (uc + 15) / 16 * 16 + 4;
        dg_off = size_t(3) * 4 * uc * hk * sizeof(bf16);                // U: 3 pieces, 4 uc rows
        slot_off = dg_off + size_t(3) * rows * 4 * uc * sizeof(bf16);   // dgates: 3 pieces
        smem = slot_off + size_t(cluster) * rows * pitch * sizeof(float);  // C receive slots
    }
    __host__ __device__ bool fits() const {
        return (cluster == 2 || cluster == 4 || cluster == 8) && rows > 0 && rows % 8 == 0 &&
               smem <= kSmemLimit && quads <= kBwdMaxQuads * kThreads;
    }
    // a step's cost in the launcher's model (SweepGeometry::step_cost's
    // units: an n-tile of the forward is hk / 8 mma steps a pass)
    long step_cost() const {
        const long mma = long((items + kSweepWarps - 1) / kSweepWarps) * item_tiles * (uc / 4);
        return kTileCost * mma + kStepCost * (hk / 8);
    }
};

// One thread's (row, 4 units) cell of a step: its gates, c_t, c_prev and
// dh_out.
struct Quad {
    float4 a[4], c, c_prev, dh_out;
};

__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float lane4(const float4& v, int u) {
    return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// The values of (row, t, units unit .. unit + 3) into v, zero past the batch
// and past H; with_c false takes c_t from v.c_prev, the last step's c_prev
// (the sweep walks t a step at a time).
template <class S>
__device__ __forceinline__ void load_quad(const S& s, int dir, int row, int t, int unit, Quad& v,
                                          bool with_c) {
    const float4 c_t = v.c_prev;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    v.c_prev = zero;
    if (row >= s.batch || unit >= s.hidden) {
        v.a[0] = v.a[1] = v.a[2] = v.a[3] = v.c = v.dh_out = zero;
        return;
    }
    const float* g = s.gates + s.row(dir, row, t) * (4 * s.hidden) + unit;
#pragma unroll
    for (int q = 0; q < 4; ++q) v.a[q] = load4(g + q * s.hidden);
    const size_t at = s.cell(dir, row, t) + unit;
    v.c = with_c ? load4(s.c_out + at) : c_t;
    v.dh_out = load4(static_cast<const float*>(s.dh_out) + at);
    const int tp = s.prev(dir, t);
    if (tp >= 0) v.c_prev = load4(s.c_out + s.cell(dir, row, tp) + unit);
}

// The offset in a dgates piece (rows x 4uc, the columns gate-major per 8
// units as U's tile has them, rows XOR-swizzled) of (row r, gate, unit ul);
// ul % 4 == 0 starts 4 columns in one 16-byte chunk.
__device__ __forceinline__ int dg_at(int r, int gate, int ul, int ku, int mask) {
    return swizzled(r, (ul >> 3) * 32 + gate * 8 + (ul & 7), ku, mask);
}

// res = the CTA's partial dh_carry of one item: out[j][r] = sum over its 4uc
// gate columns q of U[j][q] * dgates[r][q] for the m16 tile mt of j and the
// NJ n8 tiles of rows from nt0, U and the dgates in three pieces each, in
// the accumulator layout: res[n][h * 2 + e] = (j = mt * 16 + h * 8 + lane / 4,
// row (nt0 + n) * 8 + 2 * (lane % 4) + e).
template <int NJ>
__device__ __forceinline__ void carry_partial(const bf16* us, const bf16* dgs,
                                              const BwdSweepGeometry& g, int mask, int dmask,
                                              int mt, int nt0, float (&res)[NJ][4]) {
    const int lane = threadIdx.x & 31;
    const int ku = 4 * g.uc;
    const size_t u_piece = size_t(ku) * g.hk, dg_piece = size_t(g.rows) * ku;
    // ldmatrix.trans of A: matrix lane / 8 holds M half (lane / 8) % 2 and K
    // half lane / 16; its rows are U's tile rows (the reduction)
    const int a_k = (lane & 7) + ((lane >> 4) & 1) * 8, a_j = mt * 16 + ((lane >> 3) & 1) * 8;
    // ldmatrix of B: rows of the dgates tile, two n-tiles by lanes 0..31 or
    // one by lanes 0..15
    const int b_row = nt0 * 8 + (lane & 7) + (NJ > 1 ? ((lane >> 4) & 1) * 8 : 0);
    const int b_half = ((lane >> 3) & 1) * 8;
    float acc[NJ][4], lo[2][NJ][4];
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = lo[0][n][e] = lo[1][n][e] = 0.0f;
#pragma unroll 2
    for (int k = 0; k < ku; k += 16) {
        unsigned a[3][4], b[3][NJ][2];
#pragma unroll
        for (int p = 0; p < 3; ++p) {
            ldmatrix_x4_trans(a[p], us + p * u_piece + swizzled(k + a_k, a_j, g.hk, mask));
            const bf16* dp = dgs + p * dg_piece;
            if constexpr (NJ == 1) {
                ldmatrix_x2(b[p][0], dp + swizzled(b_row, k + b_half, ku, dmask));
            } else {
#pragma unroll
                for (int n = 0; n < NJ; n += 2) {
                    unsigned v[4];
                    ldmatrix_x4(v, dp + swizzled(b_row + n * 8, k + b_half, ku, dmask));
                    b[p][n][0] = v[0];
                    b[p][n][1] = v[1];
                    b[p][n + 1][0] = v[2];
                    b[p][n + 1][1] = v[3];
                }
            }
        }
        // the pair (0, 0) apart; the five smaller pairs alternately into two
        // sums (mma.sync issues in program order)
#pragma unroll
        for (int n = 0; n < NJ; ++n) {
            mma_bf16(acc[n], a[0], b[0][n]);
            mma_bf16(lo[0][n], a[0], b[1][n]);
            mma_bf16(lo[1][n], a[1], b[0][n]);
            mma_bf16(lo[0][n], a[0], b[2][n]);
            mma_bf16(lo[1][n], a[1], b[1][n]);
            mma_bf16(lo[0][n], a[2], b[0][n]);
        }
    }
#pragma unroll
    for (int n = 0; n < NJ; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) res[n][e] = acc[n][e] + lo[0][n][e] + lo[1][n][e];
}

// grid = (C, clusters per direction, 2), cluster = (C, 1, 1), kThreads
// threads, g.smem bytes of dynamic shared memory; NJ = g.item_tiles.
template <class S, int NJ>
__global__ void __launch_bounds__(kThreads, 1) lstm_bwd_sweep(const S s, const BwdSweepGeometry g,
                                                              int n_tiles) {
    // (named apart from the including file's kernels)
    extern __shared__ __align__(16) unsigned char bwd_sweep_smem[];
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const int dir = blockIdx.z;
    const int hidden = s.hidden, gates = 4 * hidden, uc = g.uc, rows = g.rows, ku = 4 * uc;
    const int mask = swizzle_mask(g.hk), dmask = swizzle_mask(ku);
    bf16* us = reinterpret_cast<bf16*>(bwd_sweep_smem);
    bf16* dgs = reinterpret_cast<bf16*>(bwd_sweep_smem + g.dg_off);
    float* slots = reinterpret_cast<float*>(bwd_sweep_smem + g.slot_off);
    const size_t dg_piece = size_t(rows) * ku;
    const int slot_elems = rows * g.pitch;

    // U's columns of this CTA's units as three pieces, once for the launch
    load_u_pieces<3>(us, static_cast<const float*>(s.u) + static_cast<size_t>(dir) * hidden * gates,
                     hidden, uc, g.hk, rank, mask);
    // U is in place, and every CTA runs before any peer writes into it
    cluster.sync();

    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int gid = lane >> 2, tq = lane & 3;
    const int per_row = uc / 4;  // quads a row
    const int n_groups = rows / 8 / NJ;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);

    for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
        const int row0 = tile * rows;
        Quad cell[kBwdMaxQuads];
        float dc[kBwdMaxQuads][4];
#pragma unroll
        for (int k = 0; k < kBwdMaxQuads; ++k) {
            const int idx = threadIdx.x + k * kThreads;
            if (idx >= g.quads) continue;
            const int r = idx / per_row, ul = (idx - r * per_row) * 4;
#pragma unroll
            for (int u = 0; u < 4; ++u) dc[k][u] = 0.0f;
            cell[k].c_prev = zero;
            load_quad(s, dir, row0 + r, s.time(dir, 0), rank * uc + ul, cell[k], true);
        }

        for (int step = 0; step < s.t_len; ++step) {
            const int t = s.time(dir, step);
            // the cells: dh_carry of the own units from the C slots, in rank
            // order; the step's dgates into the tile as three pieces
#pragma unroll
            for (int k = 0; k < kBwdMaxQuads; ++k) {
                const int idx = threadIdx.x + k * kThreads;
                if (idx >= g.quads) continue;
                const int r = idx / per_row, ul = (idx - r * per_row) * 4;
                const int row = row0 + r, unit = rank * uc + ul;
                const bool real = row < s.batch && unit < hidden;
                float4 carry = zero;
                if (step > 0) {
                    for (int c = 0; c < g.cluster; ++c) {
                        const float4 v = load4(slots + c * slot_elems + r * g.pitch + ul);
                        carry.x += v.x;
                        carry.y += v.y;
                        carry.z += v.z;
                        carry.w += v.w;
                    }
                }
                float dg[4][4];  // [gate][unit]
#pragma unroll
                for (int u = 0; u < 4; ++u) {
                    const float a[4] = {lane4(cell[k].a[0], u), lane4(cell[k].a[1], u),
                                        lane4(cell[k].a[2], u), lane4(cell[k].a[3], u)};
                    float d[4];
                    cell_backward<float>(a, lane4(cell[k].c, u), lane4(cell[k].c_prev, u),
                                         lane4(cell[k].dh_out, u) + lane4(carry, u), dc[k][u], d);
#pragma unroll
                    for (int q = 0; q < 4; ++q) dg[q][u] = real ? d[q] : 0.0f;
                }
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    bf16 piece[4];
#pragma unroll
                    for (int p = 0; p < 3; ++p) {
#pragma unroll
                        for (int u = 0; u < 4; ++u) {
                            piece[u] = __float2bfloat16_rn(dg[q][u]);
                            dg[q][u] -= __bfloat162float(piece[u]);
                        }
                        store4(dgs + p * dg_piece + dg_at(r, q, ul, ku, dmask), piece);
                    }
                }
                // the next step's loads, in flight during the product and
                // the barrier
                if (step + 1 < s.t_len)
                    load_quad(s, dir, row, s.time(dir, step + 1), unit, cell[k], false);
            }
            // phase one: this CTA's slots are read, so the peers may write
            // them again once every CTA has arrived
            cluster_arrive();
            __syncthreads();  // the step's dgates tile is complete

            // the partial sums of the next step's dh_carry, each to its
            // unit's CTA (none after the last step)
            const bool carries = step + 1 < s.t_len;
            for (int item = warp, first = 1; first || item < g.items;
                 item += kSweepWarps, first = 0) {
                const bool mine = carries && item < g.items;
                const int mt = item / n_groups, nt0 = (item - mt * n_groups) * NJ;
                float res[NJ][4];
                if (mine) carry_partial<NJ>(us, dgs, g, mask, dmask, mt, nt0, res);
                if (first) cluster_wait();  // every slot of every CTA is read
                if (!mine) continue;
#pragma unroll
                for (int h = 0; h < 2; ++h) {
                    const int j0 = mt * 16 + h * 8, owner = j0 / uc;
                    float* dst = cluster.map_shared_rank(slots, owner) + rank * slot_elems +
                                 (j0 - owner * uc + gid);
#pragma unroll
                    for (int n = 0; n < NJ; ++n) {
                        const int r = (nt0 + n) * 8 + 2 * tq;
                        dst[r * g.pitch] = res[n][2 * h];
                        dst[(r + 1) * g.pitch] = res[n][2 * h + 1];
                    }
                }
            }
            // phase two: the partial sums are out. Before waiting for the
            // peers', the step's pieces to device memory (after the arrive,
            // so that its release waits on no global store), each thread
            // its own cells: the tile is rewritten only by the same thread.
            cluster_arrive();
#pragma unroll
            for (int k = 0; k < kBwdMaxQuads; ++k) {
                const int idx = threadIdx.x + k * kThreads;
                if (idx >= g.quads) continue;
                const int r = idx / per_row, ul = (idx - r * per_row) * 4;
                const int row = row0 + r, unit = rank * uc + ul;
                if (row >= s.batch || unit >= hidden) continue;
                bf16* out = s.pieces + s.row(dir, row, t) * 3 * gates + unit;
#pragma unroll
                for (int p = 0; p < 3; ++p)
#pragma unroll
                    for (int q = 0; q < 4; ++q)
                        *reinterpret_cast<uint2*>(out + p * gates + q * hidden) =
                            *reinterpret_cast<const uint2*>(dgs + p * dg_piece +
                                                            dg_at(r, q, ul, ku, dmask));
            }
            cluster_wait();
        }
    }
}

// The kernel of a geometry's item shape.
template <class S>
auto bwd_sweep_kernel(const BwdSweepGeometry& g) -> void (*)(S, BwdSweepGeometry, int) {
    if (g.item_tiles == 4) return lstm_bwd_sweep<S, 4>;
    return g.item_tiles == 2 ? lstm_bwd_sweep<S, 2> : lstm_bwd_sweep<S, 1>;
}

// The reverse sweep's geometry under policy S (plan_sweep): the given
// (cluster, rows), or chosen where either is 0.
template <class S>
cudaError_t plan_bwd_sweep(int batch, int hidden, int& cluster, int& rows, int& per_dir) {
    return plan_sweep(
        batch, [hidden](int c, int r) { return BwdSweepGeometry(hidden, c, r); },
        [](const BwdSweepGeometry& g) { return bwd_sweep_kernel<S>(g); }, cluster, rows, per_dir,
        nullptr);
}

// Launch the reverse sweep of policy s at a geometry from plan_bwd_sweep.
template <class S>
cudaError_t launch_bwd_sweep(const S& s, int cluster, int rows, int per_dir, cudaStream_t stream) {
    const BwdSweepGeometry g(s.hidden, cluster, rows);
    const int tiles = (s.batch + rows - 1) / rows;
    cudaLaunchAttribute attr;
    cudaLaunchConfig_t cfg = sweep_config(cluster, g.smem, stream, &attr);
    cfg.gridDim = dim3(cluster, per_dir, 2);
    const cudaError_t err = cudaLaunchKernelEx(&cfg, bwd_sweep_kernel<S>(g), s, g, tiles);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace
