// Both BiLSTM layers in one launch, forward only, float32, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm2.py:_bilstm2_kernel
// (through _bilstm2_pallas and bilstm2_pallas): out = bilstm(p2,
// bilstm(p1, x)) for x (B, T, F) -> (B, T, 2*H2). Both input projections
// run inside the kernel. Layer 1's h of both directions, at the original
// time index, stays in shared memory for the tile's whole sequence, and
// layer 2 reads their concatenation from there: the (B, T, 2*H1)
// intermediate never reaches device memory.
//
// What bounds it: shared memory. A tile of kRows rows keeps
// T x kRows x 2*H1 floats (135 KB at T = 33, H1 = 128, kRows = 4) beside
// the step's inputs and h, so one block fits an SM; the T dependent steps
// of each layer, and re-reading W and U from L2 every step (one value per
// kRows FMAs), set its time. Design: blockDim = 2 * max(H1, H2); the first
// half of the threads runs the forward direction and the second half the
// backward one, at once, each thread owning one hidden unit's four gate
// columns for the tile's rows (c in registers, h in shared memory); the
// ragged batch edge is masked here. Float32 FMA; no tensor cores yet.

#include "lstm_cell.cuh"

namespace {

constexpr int kRows = 4;

// gates = b + sum_k in[r][k] * W[k][.] + sum_k h[r][k] * U[k][.] for the four
// gate columns of unit j; in has row pitch in_pitch.
__device__ __forceinline__ void gate_sums(const float* __restrict__ in, int in_pitch, int in_dim,
                                          const float* __restrict__ wd,
                                          const float* __restrict__ hs,
                                          const float* __restrict__ ud,
                                          const float* __restrict__ bd, int hidden, int j,
                                          float (&acc)[kRows][4]) {
    const int gates = 4 * hidden;
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = bd[q * hidden + j];
    for (int k = 0; k < in_dim; ++k) {
        const float* wk = wd + static_cast<size_t>(k) * gates;
        const float w0 = wk[j], w1 = wk[hidden + j], w2 = wk[2 * hidden + j];
        const float w3 = wk[3 * hidden + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const float v = in[r * in_pitch + k];
            acc[r][0] = fmaf(v, w0, acc[r][0]);
            acc[r][1] = fmaf(v, w1, acc[r][1]);
            acc[r][2] = fmaf(v, w2, acc[r][2]);
            acc[r][3] = fmaf(v, w3, acc[r][3]);
        }
    }
    for (int k = 0; k < hidden; ++k) {
        const float* uk = ud + static_cast<size_t>(k) * gates;
        const float u0 = uk[j], u1 = uk[hidden + j], u2 = uk[2 * hidden + j];
        const float u3 = uk[3 * hidden + j];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const float v = hs[r * hidden + k];
            acc[r][0] = fmaf(v, u0, acc[r][0]);
            acc[r][1] = fmaf(v, u1, acc[r][1]);
            acc[r][2] = fmaf(v, u2, acc[r][2]);
            acc[r][3] = fmaf(v, u3, acc[r][3]);
        }
    }
}

// the LSTM cell update of row r: c in place, returns h
__device__ __forceinline__ float cell(const float (&acc)[kRows][4], int r, float& c) {
    const float i_g = sigmoid(acc[r][0]);
    const float f_g = sigmoid(acc[r][1]);
    const float g_g = tanhf(acc[r][2]);
    const float o_g = sigmoid(acc[r][3]);
    c = f_g * c + i_g * g_g;
    return o_g * tanhf(c);
}

// x: (B, T, F); w1: (2, F, 4*H1), u1: (2, H1, 4*H1), b1: (2, 4*H1); w2:
// (2, 2*H1, 4*H2), u2: (2, H2, 4*H2), b2: (2, 4*H2); out: (B, T, 2*H2).
// blockDim.x == 2 * hmax with hmax = max(H1, H2), gridDim.x = ceil(B / kRows).
__global__ void bilstm2_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                               const float* __restrict__ u1, const float* __restrict__ b1,
                               const float* __restrict__ w2, const float* __restrict__ u2,
                               const float* __restrict__ b2, float* __restrict__ out,
                               int batch, int t_len, int feat, int h1, int h2) {
    extern __shared__ float smem[];
    const int hmax = blockDim.x / 2;
    const int dir = threadIdx.x / hmax;
    const int j = threadIdx.x - dir * hmax;
    const int row0 = blockIdx.x * kRows;
    const int f2 = 2 * h1;
    float* store = smem;                            // (T, kRows, 2*H1): layer 1's h
    float* x_s = store + t_len * kRows * f2;        // (2, kRows, F): the step's x per direction
    float* h_s = x_s + 2 * kRows * feat;            // (2, kRows, hmax): carried h per direction
    float* hd = h_s + dir * kRows * hmax;
    float c[kRows];
    float acc[kRows][4];

    // layer 1: direction 0 at t = step, direction 1 at t = T-1-step
    for (int idx = threadIdx.x; idx < 2 * kRows * hmax; idx += blockDim.x) h_s[idx] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) c[r] = 0.0f;
    for (int step = 0; step < t_len; ++step) {
        for (int idx = threadIdx.x; idx < 2 * kRows * feat; idx += blockDim.x) {
            const int d = idx / (kRows * feat);
            const int rk = idx - d * kRows * feat;
            const int r = rk / feat;
            const int k = rk - r * feat;
            const int t = d == 0 ? step : t_len - 1 - step;
            const int row = row0 + r;
            x_s[idx] = row < batch ? x[(static_cast<size_t>(row) * t_len + t) * feat + k] : 0.0f;
        }
        __syncthreads();  // x_s filled; the last step's h_s writes visible
        if (j < h1) {
            gate_sums(x_s + dir * kRows * feat, feat, feat,
                      w1 + static_cast<size_t>(dir) * feat * 4 * h1, hd,
                      u1 + static_cast<size_t>(dir) * h1 * 4 * h1, b1 + dir * 4 * h1, h1, j, acc);
        }
        __syncthreads();  // every read of x_s and h_s done
        if (j < h1) {
            const int t = dir == 0 ? step : t_len - 1 - step;
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float h = cell(acc, r, c[r]);
                hd[r * h1 + j] = h;
                store[(t * kRows + r) * f2 + dir * h1 + j] = h;
            }
        }
    }

    // layer 2 on [h1_fw | h1_bw] at each time index
    __syncthreads();  // layer 1 complete
    for (int idx = threadIdx.x; idx < 2 * kRows * hmax; idx += blockDim.x) h_s[idx] = 0.0f;
#pragma unroll
    for (int r = 0; r < kRows; ++r) c[r] = 0.0f;
    for (int step = 0; step < t_len; ++step) {
        const int t = dir == 0 ? step : t_len - 1 - step;
        __syncthreads();  // the last step's h_s writes (and the reset) visible
        if (j < h2) {
            gate_sums(store + t * kRows * f2, f2, f2,
                      w2 + static_cast<size_t>(dir) * f2 * 4 * h2, hd,
                      u2 + static_cast<size_t>(dir) * h2 * 4 * h2, b2 + dir * 4 * h2, h2, j, acc);
        }
        __syncthreads();  // every read of h_s done
        if (j < h2) {
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
                const float h = cell(acc, r, c[r]);
                hd[r * h2 + j] = h;
                const int row = row0 + r;
                if (row < batch) {
                    out[(static_cast<size_t>(row) * t_len + t) * 2 * h2 + dir * h2 + j] = h;
                }
            }
        }
    }
}

}  // namespace

// Plain C entry point for ctypes, float32. Launches on `stream`, does not
// synchronise, and returns the launch error as an int (0: none).
extern "C" int clair_bilstm2(const void* x, const void* w1, const void* u1, const void* b1,
                             const void* w2, const void* u2, const void* b2, void* out,
                             int batch, int t_len, int feat, int h1, int h2, void* stream) {
    const int hmax = h1 > h2 ? h1 : h2;
    const size_t smem =
        sizeof(float) * (static_cast<size_t>(t_len) * kRows * 2 * h1 + 2 * kRows * (feat + hmax));
    const cudaError_t err = allow_dynamic_smem(bilstm2_kernel, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bilstm2_kernel<<<dim3((batch + kRows - 1) / kRows), dim3(2 * hmax), smem,
                     static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(x), static_cast<const float*>(w1),
        static_cast<const float*>(u1), static_cast<const float*>(b1),
        static_cast<const float*>(w2), static_cast<const float*>(u2),
        static_cast<const float*>(b2), static_cast<float*>(out), batch, t_len, feat, h1, h2);
    return static_cast<int>(cudaGetLastError());
}
