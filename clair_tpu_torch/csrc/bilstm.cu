// The forward-only BiLSTM recurrence on precomputed input projections, both
// directions in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm.py:_bilstm_kernel
// (through _lstm_pallas and bilstm_pallas; ModelConfig.use_pallas_bilstm).
// The caller computes xw = x.W + b for every step outside the kernel, as
// bilstm_pallas does, in (2, T, N, 4H) with direction 1 already on the
// time-reversed sequence, so both directions run t = 0 .. T-1. Per step
// gates = xw_t + h.U in float32, with U read in its type and widened; h and
// c are float32 and h is NOT rounded to the input type between steps (the
// TPU kernel's h scratch is float32); the output h (2, T, N, H) is float32
// whatever the input type.
//
// What bounds it: the T dependent steps, each a small product (rows x H x
// 4H) behind the last step's h, so U must stay on chip and a step's latency
// sets the time; xw crosses device memory once (2 x T x N x 4H values,
// 8.7 MB in bf16 and 17 MB in float32 at N = 512).
//
// Design: the float32 forward sweep of lstm_sweep.cuh, launched on the
// caller's xw through the layout policy PrecomputedForward (no product
// before it, no scratch). A thread-block cluster runs one (row tile,
// direction) and holds U's columns of its units in shared memory; h.U runs
// on mma.sync with h as three bf16 pieces and float32 sums; h crosses the
// cluster through distributed shared memory. A bf16 U, the calling
// default's, is one exact piece: three tensor-core passes a step and a
// third of a float32 U's shared memory, which frees smaller tiles and
// clusters for the launcher's choice. A float32 U is three pieces, six
// passes, as rows 4 and 5 run. A bf16 xw (lstm1 under bf16) widens as it
// loads, so it crosses memory at half the bytes. H must be a multiple of 8.

#include "lstm_sweep.cuh"

namespace {

// The sweep's layout policy on bilstm_pallas's layout: xw (2, T, N, 4H) in
// XT, u (2, H, 4H) in UT, h_out (2, T, N, H) float32, no c_out.
template <typename XT, typename UT>
struct PrecomputedForward {
    using xw_type = XT;
    using u_type = UT;
    const XT* xw;
    const UT* u;
    float* h_out;
    float* c_out;  // null: h alone
    int batch, t_len, hidden;
    __device__ size_t xw_row(int dir, int r, int step) const {
        return (static_cast<size_t>(dir) * t_len + step) * batch + r;
    }
    __device__ size_t out_at(int dir, int r, int step) const {
        return xw_row(dir, r, step) * hidden;
    }
};

template <typename XT, typename UT>
cudaError_t launch(const void* xw, const void* u, void* out, int n, int t_len, int hidden,
                   int cluster, int rows, int* chosen, cudaStream_t stream) {
    if (hidden % 8) return cudaErrorInvalidValue;
    using S = PrecomputedForward<XT, UT>;
    int per_dir = 0;
    const cudaError_t err = plan_fwd_sweep<S>(n, hidden, cluster, rows, per_dir, chosen);
    if (err != cudaSuccess) return err;
    const S s{static_cast<const XT*>(xw), static_cast<const UT*>(u), static_cast<float*>(out),
              nullptr, n, t_len, hidden};
    return launch_fwd_sweep(s, cluster, rows, per_dir, stream);
}

}  // namespace

// Plain C entry point for ctypes. xw_bf16 / u_bf16 select the element type
// of xw and u (0: float32, 1: bfloat16); out is float32. The sweep runs at
// the cluster size and rows per tile given, or chosen where either is 0;
// chosen, unless null, gets four ints (lstm_sweep.cuh: plan_fwd_sweep).
// cudaErrorInvalidValue where H is no multiple of 8 or the geometry does
// not fit or launch. Launches on `stream`, does not synchronise, and
// returns the launch error as an int (0: none).
extern "C" int clair_bilstm_recurrence(const void* xw, const void* u, void* out, int n,
                                       int t_len, int hidden, int xw_bf16, int u_bf16,
                                       int cluster, int rows, int* chosen, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (xw_bf16 && u_bf16) {
        err = launch<bf16, bf16>(xw, u, out, n, t_len, hidden, cluster, rows, chosen, s);
    } else if (xw_bf16) {
        err = launch<bf16, float>(xw, u, out, n, t_len, hidden, cluster, rows, chosen, s);
    } else if (u_bf16) {
        err = launch<float, bf16>(xw, u, out, n, t_len, hidden, cluster, rows, chosen, s);
    } else {
        err = launch<float, float>(xw, u, out, n, t_len, hidden, cluster, rows, chosen, s);
    }
    return static_cast<int>(err);
}
