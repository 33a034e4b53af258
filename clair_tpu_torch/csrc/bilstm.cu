// The forward-only BiLSTM recurrence on precomputed input projections, both
// directions in one launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm.py:_bilstm_kernel
// (through _lstm_pallas and bilstm_pallas; ModelConfig.use_pallas_bilstm).
// The caller computes xw = x.W + b for every step outside the kernel, as
// bilstm_pallas does, in (2, T, N, 4H) with direction 1 already on the
// time-reversed sequence, so both directions run t = 0 .. T-1. Per step
// gates = xw_t + h.U, with U read in its type and widened; h and c are
// float32 and h is NOT rounded to the input type between steps (the TPU
// kernel's h scratch is float32); the output h (2, T, N, H) is float32
// whatever the input type.
//
// What bounds it: the T dependent steps and re-reading U (H x 4H) from L2
// every step, one value per kRows FMAs; xw crosses device memory once
// (2 x T x N x 4H values, 17 MB in float32 at N = 512). Design as the
// streaming forward's: one block per (tile of kRows rows, direction), one
// thread per hidden unit computing its four gate columns for the tile's
// rows, h in shared memory, c in registers, the ragged batch edge masked
// here (no padding). Float32 FMA; no tensor cores yet.

#include "lstm_cell.cuh"

namespace {

constexpr int kRows = 4;

// xw: (2, T, N, 4H) in XT; u: (2, H, 4H) in UT; out: (2, T, N, H) float32.
// blockDim.x == H, gridDim = (ceil(N / kRows), 2).
template <typename XT, typename UT>
__global__ void bilstm_recurrence(const XT* __restrict__ xw, const UT* __restrict__ u,
                                  float* __restrict__ out, int n, int t_len) {
    extern __shared__ float h_s[];  // (kRows, H): the carried h, float32
    const int hidden = blockDim.x;
    const int gates = 4 * hidden;
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * kRows;
    const XT* xwd = xw + static_cast<size_t>(dir) * t_len * n * gates;
    const UT* ud = u + static_cast<size_t>(dir) * hidden * gates;
    float* outd = out + static_cast<size_t>(dir) * t_len * n * hidden;

    float c[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        c[r] = 0.0f;
        h_s[r * hidden + j] = 0.0f;
    }

    for (int t = 0; t < t_len; ++t) {
        __syncthreads();  // the last step's h_s writes visible
        float acc[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int row = row0 + r;
            const XT* x = xwd + (static_cast<size_t>(t) * n + (row < n ? row : 0)) * gates;
#pragma unroll
            for (int q = 0; q < 4; ++q) acc[r][q] = row < n ? to_float(x[q * hidden + j]) : 0.0f;
        }
        for (int k = 0; k < hidden; ++k) {
            const UT* uk = ud + static_cast<size_t>(k) * gates;
            const float u0 = to_float(uk[j]);
            const float u1 = to_float(uk[hidden + j]);
            const float u2 = to_float(uk[2 * hidden + j]);
            const float u3 = to_float(uk[3 * hidden + j]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float hv = h_s[r * hidden + k];
                acc[r][0] = fmaf(hv, u0, acc[r][0]);
                acc[r][1] = fmaf(hv, u1, acc[r][1]);
                acc[r][2] = fmaf(hv, u2, acc[r][2]);
                acc[r][3] = fmaf(hv, u3, acc[r][3]);
            }
        }
        __syncthreads();  // every thread has read h_s for this step

#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const float i_g = sigmoid(acc[r][0]);
            const float f_g = sigmoid(acc[r][1]);
            const float g_g = tanhf(acc[r][2]);
            const float o_g = sigmoid(acc[r][3]);
            c[r] = f_g * c[r] + i_g * g_g;
            const float h = o_g * tanhf(c[r]);
            h_s[r * hidden + j] = h;
            const int row = row0 + r;
            if (row < n) outd[(static_cast<size_t>(t) * n + row) * hidden + j] = h;
        }
    }
}

template <typename XT, typename UT>
cudaError_t launch(const void* xw, const void* u, void* out, int n, int t_len, int hidden,
                   cudaStream_t stream) {
    const size_t smem = sizeof(float) * kRows * hidden;
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_dynamic_smem(bilstm_recurrence<XT, UT>, smem);
        if (err != cudaSuccess) return err;
    }
    bilstm_recurrence<XT, UT><<<dim3((n + kRows - 1) / kRows, 2), dim3(hidden), smem, stream>>>(
        static_cast<const XT*>(xw), static_cast<const UT*>(u), static_cast<float*>(out), n,
        t_len);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. xw_bf16 / u_bf16 select the element type
// of xw and u (0: float32, 1: bfloat16); out is float32. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() as an int.
extern "C" int clair_bilstm_recurrence(const void* xw, const void* u, void* out, int n,
                                       int t_len, int hidden, int xw_bf16, int u_bf16,
                                       void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (xw_bf16 && u_bf16) {
        err = launch<__nv_bfloat16, __nv_bfloat16>(xw, u, out, n, t_len, hidden, s);
    } else if (xw_bf16) {
        err = launch<__nv_bfloat16, float>(xw, u, out, n, t_len, hidden, s);
    } else if (u_bf16) {
        err = launch<float, __nv_bfloat16>(xw, u, out, n, t_len, hidden, s);
    } else {
        err = launch<float, float>(xw, u, out, n, t_len, hidden, s);
    }
    return static_cast<int>(err);
}
