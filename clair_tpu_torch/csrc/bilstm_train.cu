// The resident training BiLSTM of one layer, forward and backward, float32,
// for Hopper (sm_90a).
//
// Replaces the TPU kernels clair_tpu/ops/pallas_bilstm_train.py:_fwd_kernel
// (through _fwd_pallas and bilstm_train_pallas's forward) and :_bwd_kernel
// (through _bwd_pallas and _bilstm_bwd). The layout is theirs: xs is
// (T, 2B, F) with the time-reversed sequence in rows B.. (the caller's
// _stack_directions), so one recurrence serves both directions and a block
// takes its direction's W, U and b; h_out, c_out and dh_out are (T, 2B, H),
// dx is (T, 2B, F). Both directions run t = 0 .. T-1 forward and
// t = T-1 .. 0 backward, with h_{-1} = c_{-1} = 0.
//
// Forward: per step gates = x_t.W + h.U + b in float32, i, f, o = sigmoid,
// g = tanh, c' = f*c + i*g, h' = o*tanh(c'); h and c of every step go out (c
// is the backward's residual). Three parts behind one launch of the entry
// point: (pieces) xs and W split into three bf16 pieces in scratch; (a)
// xw = xs.W + b for every step at once, the backward's gate product (a)
// below restricted to the x columns, into a (T, 2B, 4H) float32 buffer;
// (b) the float32 forward sweep of lstm_sweep.cuh on the stacked layout
// (StackedForward): U's three pieces held across a thread-block cluster,
// h.U on mma.sync, h exchanged through distributed shared memory. What
// bounds each part, at B = 10,000: (a) six passes of 2 * 2B*T * F * 4H
// tensor-core operations and the 1.35 GB of xw it writes; (b) the serial
// chain of T steps a row tile, a step's h.U (six passes of 2 * rows * H *
// 4H) and its exchange, and the 1.35 GB of xw it reads; (pieces) bytes.
// Measured, both layers (lstm1 + lstm2, CUDA events) on an H100 80GB HBM3
// at 700 W: at B = 10,000, 11.38 ms against the design before this one
// (one thread per hidden unit, float32 FMA, re-reading W and U from L2
// every step for 16 rows, 4 below B = 4096) at 15.94, in turns in one run
// (tools/torch_step_compare.py --kernels); split (chip_smoke.py phase 9a,
// torch.profiler) lstm1 pieces 0.07, xw 1.18, sweep 2.81; lstm2 pieces
// 0.57, xw 3.70, sweep 2.84. At B = 512: 0.70 against 2.78 ms.
//
// Backward: the TPU kernel's reverse sweep, built from the streaming
// backward's parts (mma_product.cuh: the split-bf16 tensor-core product;
// lstm_bwd_sweep.cuh: the float32 cluster sweep). Four kernels behind one
// launch of the entry
// point, on the stacked layout: row n of 2B is direction n / B, and in the
// products a direction's T*B rows are m = t*B + r, at row (t*2 + d)*B + r
// of the (T, 2B, .) tensors (m / B by a float reciprocal with a
// correction, exact below 2^24 rows).
// (pieces) xs, h_out, W and U split once into three bf16 pieces in scratch.
// (a) gates[t][n] = [xs_t | h_{t-1}][n] . [W_d ; U_d] + b_d for every step at
//     once (h_{t-1} is the saved h_out, zero at t = 0): one product over
//     each direction's T*B rows (grid.z = d), written as float32 into a
//     (T, 2B, 4H) buffer.
// (b) the reverse sweep t = T-1 .. 0 over all 2B rows. It reads an entry's
//     gates once with c_t, c_{t-1} and dh_out_t, forms
//       dgates = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i(1-g^2), dh*tanh(c)*o(1-o)]
//     with dh = dh_out_t + dh_carry and dc = dc_carry + dh*o*(1 - tanh^2 c),
//     carries dh_carry = dgates.U^T and dc_carry = dc*f, and writes dgates
//     as three bf16 pieces to scratch: lstm_bwd_sweep.cuh through the
//     policy StackedSweep (a cluster of 2, 4 or 8 CTAs holds U's three bf16
//     pieces, each CTA's partial dgates.U^T over its own gate columns on
//     mma.sync, the partials summed in rank order through distributed
//     shared memory).
// (c) dW, dU (A^T . dgates, A = [xs_t | h_{t-1}]) and db over fixed chunks of
//     each direction's T*B rows into float32 partials that the caller sums
//     in a fixed order: no atomics, the same bits every run.
// (d) only where dx is wanted: dx[t][n] = dgates[t][n] . W_d^T, the
//     reduction over the row's own direction's 4H (the caller un-reverses
//     rows B.. and adds the halves).
// Numerics: every product takes its float32 operands as three bf16 pieces,
// six passes, float32 sums (float32-level products; two pieces missed the
// TPU kernel's gradients by 2.8x on the CPU emulation), the carry too; the
// cell's backward stays float32.
// What bounds each kernel (B = 10,000, T = 33, H = 128; PERF.md has the
// measured split, tools/torch_stream_bwd_parts.py --pair train):
// - (a), (c), (d): tensor-core operations, 2 * 2B*T * (F + H) * 4H for (a)
//   and for (c), 2 * 2B*T * 4H * F for (d), times six passes; and bytes:
//   the float32 gates (1.35 GB, written by (a), read by (b)) and the
//   dgates' pieces (2.03 GB at lstm2, written by (b), read by (c) and (d)).
// - (b): the serial chain of T steps (a step's loads, the elementwise
//   backward, the carry's six-pass product and the exchange of its partial
//   sums), and its bytes: gates, c and dh_out read, the pieces written.
// - (pieces): bytes, the float32 operands read once and 1.5 times their
//   bytes written.
// Measured, ms at B = 10,000 on an H100 80GB HBM3 at 700 W:
//   the earlier design (a persistent grid recomputing the gates on the
//     serial chain in float32 FMA, re-reading [W ; U] and its transpose
//     from L2 every step for 16 rows, weight sums by an 8 x 8
//     register-tiled FMA product): 63.02 both layers (CUDA events,
//     tools/torch_step_compare.py --kernels);
//   this design, split by kernel (tools/torch_stream_bwd_parts.py --pair
//     train, torch.profiler device time), with the sweep in float32 FMA (U^T
//     streamed from L2 every step, 4 or 8 rows a block): lstm1 gates 2.603,
//     sweep 5.442, sums 3.375, pieces 0.443 (11.89 the call); lstm2 gates
//     5.083, sweep 5.262, sums 4.735, dx 3.355, pieces 1.059 (20.13 the
//     call); with the cluster sweep: PERF.md §6 (chip_smoke.py phase 9a).
// Left for later, as for the streaming backward: wgmma and TMA in the
// products, one read of dgates feeding both dx and the weight sums.

#include "lstm_bwd_sweep.cuh"

namespace {

// ---- the backward's problems on the stacked layout ------------------------

// [xs_t | h_{t-1}] of direction dir: row m of the direction's T*B rows is
// (t, r) = (m / B, m % B), at row (t * 2 + dir) * B + r of the (T, 2B, .)
// tensors; column k of F + H.
struct StackedXH {
    Pieces x, h;
    int batch, t_len, feat, hidden;
    float inv_b;  // 1 / B: m / B by a float product (m < 2^24), corrected
    __device__ int rows() const { return batch * t_len; }
    // the step t of row m, and in r its row of the direction
    __device__ int step(int m, int& r) const { return split_row(m, batch, inv_b, r); }
    __device__ size_t row_of(int t, int dir, int r) const {
        return (static_cast<size_t>(t) * 2 + dir) * batch + r;
    }
    __device__ size_t global(int m, int dir) const {
        int r;
        const int t = step(m, r);
        return row_of(t, dir, r);
    }
    __device__ const bf16* at(int m, int k, int dir, int& ps) const {
        if (m >= rows() || k >= feat + hidden) return nullptr;
        int r;
        const int t = step(m, r);
        if (k < feat) return x.at(row_of(t, dir, r), k, ps);
        if (t == 0) return nullptr;  // h_{-1} = 0
        return h.at(row_of(t - 1, dir, r), k - feat, ps);
    }
};

// (a) gates[t][n][g] = [xs_t | h_{t-1}][n] . [W ; U][:, g] + b[g] over the
// columns k < k_stop of [xs_t | h_{t-1}]: F + H for the backward's gates,
// F for the forward's xw = xs.W + b; grid.z = dir.
struct StackedGateProblem {
    static constexpr bool kAK = true, kBKMajor = false;  // A [m][k]; B [k][g]
    static constexpr bool kDb = false;
    StackedXH xh;
    Pieces w, u;
    const float* b;
    float* out;  // (T, 2B, 4H)
    int gates, k_stop;
    __device__ int dir() const { return blockIdx.z; }
    __device__ const void* base() const { return xh.x.base; }
    __device__ int k_begin() const { return 0; }
    __device__ int k_end() const { return k_stop; }
    __device__ int m_extent() const { return xh.rows(); }
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
        *reinterpret_cast<float2*>(out + xh.global(m, dir()) * gates + g) =
            make_float2(v0 + bd[g], v1 + bd[g + 1]);
    }
    __device__ void store_db(int, float) const {}
};

// (c) partial[split][dir][a][g] = sum over the chunk's rows m of the
// direction of A[m][a] * dgates[m][g], and row F + H the chunk's sum of
// dgates; grid.z = split * 2 + dir.
struct StackedWeightSumProblem {
    static constexpr bool kAK = false, kBKMajor = false;  // A [m][a]; B [m][g]
    static constexpr bool kDb = true;
    StackedXH xh;
    Pieces dg;  // (T, 2B) rows of the dgates' pieces
    float* partial;
    int gates, rows_per_split;
    __device__ int dir() const { return blockIdx.z & 1; }
    __device__ const void* base() const { return dg.base; }
    __device__ int k_begin() const { return (blockIdx.z >> 1) * rows_per_split; }
    __device__ int k_end() const { return min(xh.rows(), k_begin() + rows_per_split); }
    __device__ int m_extent() const { return xh.feat + xh.hidden; }
    __device__ int n_extent() const { return gates; }
    __device__ const bf16* a(int m, int k, int& ps) const { return xh.at(m, k, dir(), ps); }
    __device__ const bf16* bm(int m, int g, int& ps) const {
        if (m >= xh.rows() || g >= gates) return nullptr;
        return dg.at(xh.global(m, dir()), g, ps);
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

// (d) dx[t][n][f] = sum over g of dgates[t][n][g] * W[dir][f][g], the
// reduction over the row's own direction's 4H gates; grid.z = dir.
struct StackedDxProblem {
    static constexpr bool kAK = true, kBKMajor = true;  // A [m][g]; B [f][g]
    static constexpr bool kDb = false;
    StackedXH xh;  // the row map
    Pieces dg, w;
    float* dx;  // (T, 2B, F)
    int gates;
    __device__ int dir() const { return blockIdx.z; }
    __device__ const void* base() const { return dg.base; }
    __device__ int k_begin() const { return 0; }
    __device__ int k_end() const { return gates; }
    __device__ int m_extent() const { return xh.rows(); }
    __device__ int n_extent() const { return xh.feat; }
    __device__ const bf16* a(int m, int g, int& ps) const {
        if (m >= xh.rows()) return nullptr;
        return dg.at(xh.global(m, dir()), g, ps);
    }
    __device__ const bf16* bm(int f, int g, int& ps) const {
        if (f >= xh.feat) return nullptr;
        return w.at(dir() * xh.feat + f, g, ps);
    }
    __device__ void store(int m, int f, float v0, float v1) const {
        *reinterpret_cast<float2*>(dx + xh.global(m, dir()) * xh.feat + f) = make_float2(v0, v1);
    }
    __device__ void store_db(int, float) const {}
};

// (b) the reverse sweep's layout policy (lstm_bwd_sweep.cuh): both
// directions sweep t = T-1 .. 0, an entry (dir, r, t) at row (t*2 + dir)*B + r.
struct StackedSweep {
    const float* gates;   // (T, 2B, 4H) float32 pre-activations
    bf16* pieces;         // dgates out: (T, 2B) rows of three pieces x 4H bf16
    const float* c_out;   // (T, 2B, H)
    const void* dh_out;   // (T, 2B, H) float32
    const float* u;       // (2, H, 4H)
    int batch, t_len, hidden;
    __device__ int time(int, int step) const { return t_len - 1 - step; }
    __device__ size_t row(int dir, int r, int t) const {
        return (static_cast<size_t>(t) * 2 + dir) * batch + r;
    }
    __device__ size_t cell(int dir, int r, int t) const { return row(dir, r, t) * hidden; }
    __device__ int prev(int, int t) const { return t - 1; }
};

// The scratch: three bf16 pieces of xs (T*2B, F), h_out (T*2B, H), W (2F, 4H),
// U (2H, 4H) and the dgates (T*2B, 4H).
size_t scratch_elems(size_t rows2, int feat, int hidden) {
    const size_t gates = 4 * static_cast<size_t>(hidden);
    return 3 * (rows2 * feat + rows2 * hidden + 2 * feat * gates + 2 * hidden * gates +
                rows2 * gates);
}

cudaError_t launch_bwd(const void* xs, const void* w, const void* u, const void* b,
                       const void* h_out, const void* c_out, const void* dh_out, void* gate_buf,
                       void* partial, void* dx, void* scratch, long long scratch_bytes, int batch,
                       int t_len, int feat, int hidden, int splits, int rows_per_split,
                       int cluster, int sweep_rows, cudaStream_t stream) {
    const size_t rows2 = 2 * static_cast<size_t>(batch) * t_len;  // every row of (T, 2B)
    const int rows = batch * t_len;                                 // a direction's
    const int gates = 4 * hidden;
    if (feat % 8 || hidden % 8 || scratch == nullptr ||
        static_cast<size_t>(scratch_bytes) < sizeof(bf16) * scratch_elems(rows2, feat, hidden))
        return cudaErrorInvalidValue;
    int per_dir = 0;
    cudaError_t err = plan_bwd_sweep<StackedSweep>(batch, hidden, cluster, sweep_rows, per_dir);
    if (err != cudaSuccess) return err;
    bf16* at = static_cast<bf16*>(scratch);
    auto carve = [&](const void* src, size_t n_rows, int cols, Pieces& out) {
        out = Pieces{at, cols};
        if (src != nullptr && err == cudaSuccess) err = launch_split(src, at, n_rows, cols, stream);
        at += 3 * n_rows * cols;
    };
    Pieces xp, hp, wp, up, dgp;
    carve(xs, rows2, feat, xp);
    carve(h_out, rows2, hidden, hp);
    carve(w, 2 * static_cast<size_t>(feat), gates, wp);
    carve(u, 2 * static_cast<size_t>(hidden), gates, up);
    carve(nullptr, rows2, gates, dgp);  // written by the sweep
    if (err != cudaSuccess) return err;
    const StackedXH xh{xp, hp, batch, t_len, feat, hidden, 1.0f / batch};
    float* gate_out = static_cast<float*>(gate_buf);

    const StackedGateProblem gp{xh, wp, up, static_cast<const float*>(b), gate_out, gates,
                                feat + hidden};
    err = launch_product(gp, gates, rows, 2, stream);
    if (err != cudaSuccess) return err;

    const StackedSweep s{gate_out, const_cast<bf16*>(dgp.base), static_cast<const float*>(c_out),
                         dh_out, static_cast<const float*>(u), batch, t_len, hidden};
    err = launch_bwd_sweep(s, cluster, sweep_rows, per_dir, stream);
    if (err != cudaSuccess) return err;

    const StackedWeightSumProblem wsp{xh, dgp, static_cast<float*>(partial), gates, rows_per_split};
    err = launch_product(wsp, gates, feat + hidden, splits * 2, stream);
    if (err != cudaSuccess || dx == nullptr) return err;

    const StackedDxProblem dp{xh, dgp, wp, static_cast<float*>(dx), gates};
    return launch_product(dp, feat, rows, 2, stream);
}


// ---- the forward --------------------------------------------------------

// The sweep's layout policy (lstm_sweep.cuh) on the stacked layout: both
// directions run t = 0 .. T-1, an entry (dir, r, t) at row (t*2 + dir)*B + r
// of xw (T, 2B, 4H) and of h_out and c_out (T, 2B, H).
struct StackedForward {
    using xw_type = float;
    using u_type = float;
    const float* xw;
    const float* u;  // (2, H, 4H)
    float* h_out;
    float* c_out;    // null: h alone
    int batch, t_len, hidden;
    __device__ size_t xw_row(int dir, int r, int step) const {
        return (static_cast<size_t>(step) * 2 + dir) * batch + r;
    }
    __device__ size_t out_at(int dir, int r, int step) const {
        return xw_row(dir, r, step) * hidden;
    }
};

// The forward's scratch: three bf16 pieces of xs (T*2B, F) and of W (2F, 4H).
size_t fwd_scratch_elems(size_t rows2, int feat, int hidden) {
    return 3 * (rows2 * feat + 2 * static_cast<size_t>(feat) * 4 * hidden);
}

cudaError_t launch_fwd(const void* xs, const void* w, const void* u, const void* b, void* h_out,
                       void* c_out, void* xw, void* scratch, long long scratch_bytes, int batch,
                       int t_len, int feat, int hidden, int cluster, int rows, int* chosen,
                       cudaStream_t stream) {
    const size_t rows2 = 2 * static_cast<size_t>(batch) * t_len;
    const int gates = 4 * hidden;
    if (feat % 8 || hidden % 8 || scratch == nullptr ||
        static_cast<size_t>(scratch_bytes) < sizeof(bf16) * fwd_scratch_elems(rows2, feat, hidden))
        return cudaErrorInvalidValue;
    int per_dir = 0;
    cudaError_t err = plan_fwd_sweep<StackedForward>(batch, hidden, cluster, rows, per_dir, chosen);
    if (err != cudaSuccess) return err;
    // (pieces) xs and W
    bf16* xp = static_cast<bf16*>(scratch);
    bf16* wp = xp + 3 * rows2 * feat;
    err = launch_split(xs, xp, rows2, feat, stream);
    if (err == cudaSuccess) err = launch_split(w, wp, 2 * static_cast<size_t>(feat), gates, stream);
    if (err != cudaSuccess) return err;
    // (a) xw = xs.W + b for every step at once, both directions
    const StackedXH xh{Pieces{xp, feat}, Pieces{}, batch, t_len, feat, hidden, 1.0f / batch};
    const StackedGateProblem gp{xh, Pieces{wp, gates}, Pieces{}, static_cast<const float*>(b),
                                static_cast<float*>(xw), gates, feat};
    err = launch_product(gp, gates, batch * t_len, 2, stream);
    if (err != cudaSuccess) return err;
    // (b) the sweep
    const StackedForward s{static_cast<const float*>(xw), static_cast<const float*>(u),
                           static_cast<float*>(h_out), static_cast<float*>(c_out), batch, t_len,
                           hidden};
    return launch_fwd_sweep(s, cluster, rows, per_dir, stream);
}

}  // namespace

// Plain C entry points for ctypes, float32 only. Each launches on `stream`,
// does not synchronise, and returns the launch error as an int (0: none).

// The forward: h_out (T, 2B, H) and, unless null, c_out (T, 2B, H) from xs
// (T, 2B, F), in three parts: the pieces of xs and W into scratch
// (scratch_bytes >= 2 * 3 * (T*2B*F + 2F*4H)), xw = xs.W + b into the
// (T, 2B, 4H) float32 buffer xw, and the sweep at the cluster size and rows
// per tile given, or chosen where either is 0; chosen, unless null, gets
// four ints (lstm_sweep.cuh: plan_fwd_sweep). F and H must be multiples of
// 8, and xs, w, u, b, xw and scratch 16-byte aligned; cudaErrorInvalidValue
// otherwise, and where the geometry does not fit or launch.
extern "C" int clair_bilstm_train_fwd(const void* xs, const void* w, const void* u,
                                      const void* b, void* h_out, void* c_out, void* xw,
                                      void* scratch, long long scratch_bytes, int batch,
                                      int t_len, int feat, int hidden, int cluster, int rows,
                                      int* chosen, void* stream) {
    return static_cast<int>(launch_fwd(xs, w, u, b, h_out, c_out, xw, scratch, scratch_bytes,
                                       batch, t_len, feat, hidden, cluster, rows, chosen,
                                       static_cast<cudaStream_t>(stream)));
}

// The backward: dx (T, 2B, F) unless null, and the partial sums of dW, dU
// and db, partial (splits, 2, F + H + 1, 4H) float32, chunk `split` of each
// direction covering its rows m = t*B + r in [split * rows_per_split, ...)
// (every element written). gates is a (T, 2B, 4H) float32 buffer; scratch
// holds scratch_bytes >= 2 * 3 * (T*2B*F + T*2B*H + 2F*4H + 2H*4H + T*2B*4H)
// bytes (the bf16 pieces of xs, h_out, W, U and the dgates). The reverse
// sweep runs at the cluster size and rows per tile given, or chosen where
// either is 0 (lstm_sweep.cuh: plan_sweep). F and H must be multiples of 8,
// and every pointer 16-byte aligned; cudaErrorInvalidValue otherwise, and
// before any launch where the geometry does not fit or launch.
extern "C" int clair_bilstm_train_bwd(const void* xs, const void* w, const void* u,
                                      const void* b, const void* h_out, const void* c_out,
                                      const void* dh_out, void* gates, void* partial, void* dx,
                                      void* scratch, long long scratch_bytes, int batch,
                                      int t_len, int feat, int hidden, int splits,
                                      int rows_per_split, int cluster, int rows, void* stream) {
    return static_cast<int>(launch_bwd(xs, w, u, b, h_out, c_out, dh_out, gates, partial, dx,
                                       scratch, scratch_bytes, batch, t_len, feat, hidden, splits,
                                       rows_per_split, cluster, rows,
                                       static_cast<cudaStream_t>(stream)));
}
