// Forward recurrence of one bidirectional LSTM layer, both directions in one
// launch, for Hopper (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm_stream.py:_fwd_kernel
// (reached through _fwd_pallas and bilstm_train_stream's forward). Same math:
// per step gates = x_t.W + h.U + b accumulated in float32, i, f, o = sigmoid,
// g = tanh, c' = f*c + i*g in float32, h' = o*tanh(c'); h is rounded to the
// input type every step (it feeds the next step's product in that type).
//
// What bounds it: the recurrence is serial in t and small in work. One layer
// costs 2*(F+H)*4H*T*2B FLOPs, about 19 GFLOP for both layers of a
// 512-row batch (F = 32 and 256, H = 128, T = 33), spread over only
// 2 * ceil(B / kRows) blocks of H threads. The kernel is bound by the latency
// of the 33 dependent steps and by how fast each block streams W and U from
// L2, not by device memory: W and U (at most 384 x 512 per direction) stay
// L2-resident, and only x, h_out and c_out cross device memory, once each.
//
// Design, against the Pallas grid:
// - The sequential t grid axis becomes a loop inside each block; h (shared
//   memory) and c (registers) stay on chip across the 33 steps.
// - One block per (tile of kRows rows, direction); thread j owns hidden unit
//   j and computes its four gate columns j, H+j, 2H+j, 3H+j for all rows of
//   the tile, so the c/h update needs no exchange between threads.
// - The backward direction reads x[:, T-1-t] and writes its output at the
//   original time index, into the second half of the feature axis: no
//   reversed or direction-stacked copy of x or of the output is made.
// - The ragged batch edge is masked here; no padding in the caller.
// - The input projection x_t.W happens inside the kernel, as in the TPU body.
// Tensor cores (wgmma), TMA and a shared-memory U are later work.

#include "lstm_cell.cuh"

namespace {

// batch rows per block: 4 measured fastest of 1, 2, 4, 8 and 16 at batch 512
// on an H100 (more blocks in flight against fewer rows to share each W/U load)
constexpr int kRows = 4;

// x: (batch, t_len, feat); w: (2, feat, 4H); u: (2, H, 4H); b: (2, 4H) float32.
// h_out: (batch, t_len, 2H) in T; c_out: the same shape in float32, or null.
// blockDim.x == H, gridDim = (ceil(batch / kRows), 2).
template <typename T>
__global__ void bilstm_stream_fwd_kernel(const T* __restrict__ x,
                                         const T* __restrict__ w,
                                         const T* __restrict__ u,
                                         const float* __restrict__ b,
                                         T* __restrict__ h_out,
                                         float* __restrict__ c_out,
                                         int batch, int t_len, int feat) {
    extern __shared__ float smem[];
    const int hidden = blockDim.x;
    const int gates = 4 * hidden;
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * kRows;
    float* x_s = smem;                  // (kRows, feat): this step's inputs
    float* h_s = smem + kRows * feat;   // (kRows, H): the carried h, as T values

    const T* wd = w + static_cast<size_t>(dir) * feat * gates;
    const T* ud = u + static_cast<size_t>(dir) * hidden * gates;
    const float* bd = b + dir * gates;
    const float b_i = bd[j], b_f = bd[hidden + j];
    const float b_g = bd[2 * hidden + j], b_o = bd[3 * hidden + j];

    float c[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        c[r] = 0.0f;
        h_s[r * hidden + j] = 0.0f;
    }

    for (int step = 0; step < t_len; ++step) {
        const int t = dir == 0 ? step : t_len - 1 - step;
        for (int idx = j; idx < kRows * feat; idx += hidden) {
            const int r = idx / feat;
            const int k = idx - r * feat;
            const int row = row0 + r;
            x_s[idx] = row < batch
                ? to_float(x[(static_cast<size_t>(row) * t_len + t) * feat + k])
                : 0.0f;
        }
        __syncthreads();  // x_s filled; last step's h_s writes visible

        float acc[kRows][4];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            acc[r][0] = b_i;
            acc[r][1] = b_f;
            acc[r][2] = b_g;
            acc[r][3] = b_o;
        }
        for (int k = 0; k < feat; ++k) {
            const T* wk = wd + static_cast<size_t>(k) * gates;
            const float w0 = to_float(wk[j]);
            const float w1 = to_float(wk[hidden + j]);
            const float w2 = to_float(wk[2 * hidden + j]);
            const float w3 = to_float(wk[3 * hidden + j]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float xv = x_s[r * feat + k];
                acc[r][0] = fmaf(xv, w0, acc[r][0]);
                acc[r][1] = fmaf(xv, w1, acc[r][1]);
                acc[r][2] = fmaf(xv, w2, acc[r][2]);
                acc[r][3] = fmaf(xv, w3, acc[r][3]);
            }
        }
        for (int k = 0; k < hidden; ++k) {
            const T* uk = ud + static_cast<size_t>(k) * gates;
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
        __syncthreads();  // every thread has read x_s and h_s for this step

#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const float i_g = sigmoid(acc[r][0]);
            const float f_g = sigmoid(acc[r][1]);
            const float g_g = tanhf(acc[r][2]);
            const float o_g = sigmoid(acc[r][3]);
            c[r] = f_g * c[r] + i_g * g_g;
            const T h = from_float<T>(o_g * tanhf(c[r]));
            h_s[r * hidden + j] = to_float(h);
            const int row = row0 + r;
            if (row < batch) {
                const size_t o =
                    (static_cast<size_t>(row) * t_len + t) * (2 * hidden) + dir * hidden + j;
                h_out[o] = h;
                if (c_out != nullptr) c_out[o] = c[r];
            }
        }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* u, const void* b,
                   void* h_out, void* c_out, int batch, int t_len, int feat,
                   int hidden, cudaStream_t stream) {
    const dim3 grid((batch + kRows - 1) / kRows, 2);
    const dim3 block(hidden);
    const size_t smem = sizeof(float) * kRows * (feat + hidden);
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_dynamic_smem(bilstm_stream_fwd_kernel<T>, smem);
        if (err != cudaSuccess) return err;
    }
    bilstm_stream_fwd_kernel<T><<<grid, block, smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(u),
        static_cast<const float*>(b), static_cast<T*>(h_out), static_cast<float*>(c_out),
        batch, t_len, feat);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. is_bf16 selects the element type of x, w,
// u and h_out (0: float32, 1: bfloat16). c_out may be null. Launches on
// `stream`, does not synchronise, and returns cudaGetLastError() as an int.
extern "C" int clair_bilstm_stream_fwd(const void* x, const void* w, const void* u,
                                       const void* b, void* h_out, void* c_out,
                                       int batch, int t_len, int feat, int hidden,
                                       int is_bf16, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? launch<__nv_bfloat16>(x, w, u, b, h_out, c_out, batch, t_len, feat, hidden, s)
        : launch<float>(x, w, u, b, h_out, c_out, batch, t_len, feat, hidden, s);
    return static_cast<int>(err);
}
