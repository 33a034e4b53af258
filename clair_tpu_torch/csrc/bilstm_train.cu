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
// is the backward's residual). One block per (tile of kFwdRows rows,
// direction), one thread per hidden unit; h in shared memory and c in
// registers across the T steps. Like the streaming forward it is bound by
// the latency of the T dependent steps and by re-reading W and U from L2
// every step, each value used by kFwdRows rows (16 at a training batch, 4
// below kLargeBatch, where 16-row tiles would leave SMs idle); only xs,
// h_out and c_out cross device memory, once each.
//
// Backward: the TPU kernel's reverse sweep. Per step it recomputes the gates
// from [x_t | h_{t-1}], forms
//   dgates = [dc*g*i(1-i), dc*c_{t-1}*f(1-f), dc*i(1-g^2), dh*tanh(c)*o(1-o)]
// with dh = dh_out_t + dh_carry and dc = dc_carry + dh*o*(1 - tanh^2 c), and
// gives [dx_t | dh_carry] = dgates.[W ; U]^T and dc_carry = dc*f; dh and dc
// stay in shared memory across the T steps.
// The weight gradients grow inside the kernel, as the TPU kernel's grow in
// VMEM beside its sweep, but blocks here run in no order, so the grid is
// persistent: blocks_per_dir blocks per direction (the caller gives the SM
// count, so with two blocks an SM every block is resident), each walking
// the row tiles tile = blockIdx.x, + gridDim.x, ... of its direction into a
// partial slot of its own, (F + H + 1) x 4H float32 (dW, dU, db). During a
// tile's sweep the step's dgates go to the block's own scratch, one tile
// deep (T x kBwdRows x 4H floats); after the sweep the block adds
// [x_t | h_{t-1} | 1]^T.dgates over the tile's T x kBwdRows rows into its
// slot, an 8 x 8 register-tiled product. The caller sums the slots of each
// direction in a fixed order: no atomics, the same bits every run.
// Bytes at lstm2 (F = 256, H = 128), 132 SMs, any batch: slots
// 2 x 132 x 788 KB = 208 MB, scratch 2 x 132 x 1.08 MB = 285 MB; a
// whole-batch dgates buffer would be 2 x B x T x 4H x 4 = 1.35 GB at
// B = 10,000.
// The sweep re-reads [W ; U] and its transpose (a layout copy made by the
// caller, so both products read coalesced) from L2 every step, each value
// used by kBwdRows rows: ~1.6 MB of L2 reads a step and block at lstm2,
// the bound that 16-row tiles halve against 8. Float32 FMA throughout; no
// tensor cores (wgmma), TMA or clusters yet.

#include "lstm_cell.cuh"

namespace {

// forward: rows per block, by batch. On an H100 (700 W), 16 rows against 4
// ran lstm1/lstm2 in 5.0/10.9 ms against 6.2/14.2 at B = 10,000, and in
// 1.4/3.2 ms against 0.87/1.96 at B = 512 (fewer blocks than the card
// holds); the crossover between the two batches is not measured
constexpr int kFwdRowsSmall = 4;
constexpr int kFwdRowsLarge = 16;
constexpr int kLargeBatch = 4096;
// backward: rows per tile; 16 rows and two blocks an SM (registers capped at
// 128) ran lstm2 at B = 10,000 in 44.4 ms against 80.2 for 8 rows and one
// block (H100, 700 W)
constexpr int kBwdRows = 16;
constexpr int kThreads = 256;  // backward: threads per block
// the weight-sum product: output tiles of kWA rows of [x | h | 1] by kWG gates
constexpr int kWA = 64;
constexpr int kWG = 256;

// xs: (T, 2B, F); w: (2, F, 4H); u: (2, H, 4H); b: (2, 4H).
// h_out, c_out: (T, 2B, H). blockDim.x == H, gridDim = (ceil(B / kFwdRows), 2).
template <int kFwdRows>
__global__ void train_fwd(const float* __restrict__ xs, const float* __restrict__ w,
                          const float* __restrict__ u, const float* __restrict__ b,
                          float* __restrict__ h_out, float* __restrict__ c_out,
                          int batch, int t_len, int feat) {
    extern __shared__ float smem[];
    const int hidden = blockDim.x;
    const int gates = 4 * hidden;
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * kFwdRows;  // within the direction's B rows
    const size_t n2 = 2 * static_cast<size_t>(batch);
    float* x_s = smem;                      // (kFwdRows, F): this step's inputs
    float* h_s = smem + kFwdRows * feat;    // (kFwdRows, H): the carried h

    const float* wd = w + static_cast<size_t>(dir) * feat * gates;
    const float* ud = u + static_cast<size_t>(dir) * hidden * gates;
    const float* bd = b + dir * gates;
    const float b_i = bd[j], b_f = bd[hidden + j];
    const float b_g = bd[2 * hidden + j], b_o = bd[3 * hidden + j];

    float c[kFwdRows];
#pragma unroll
    for (int r = 0; r < kFwdRows; ++r) {
        c[r] = 0.0f;
        h_s[r * hidden + j] = 0.0f;
    }

    for (int t = 0; t < t_len; ++t) {
        const size_t step_rows = t * n2 + static_cast<size_t>(dir) * batch;
        for (int idx = j; idx < kFwdRows * feat; idx += hidden) {
            const int r = idx / feat;
            const int k = idx - r * feat;
            const int row = row0 + r;
            x_s[idx] = row < batch ? xs[(step_rows + row) * feat + k] : 0.0f;
        }
        __syncthreads();  // x_s filled; last step's h_s writes visible

        float acc[kFwdRows][4];
#pragma unroll
        for (int r = 0; r < kFwdRows; ++r) {
            acc[r][0] = b_i;
            acc[r][1] = b_f;
            acc[r][2] = b_g;
            acc[r][3] = b_o;
        }
        for (int k = 0; k < feat; ++k) {
            const float* wk = wd + static_cast<size_t>(k) * gates;
            const float w0 = wk[j], w1 = wk[hidden + j], w2 = wk[2 * hidden + j];
            const float w3 = wk[3 * hidden + j];
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r) {
                const float xv = x_s[r * feat + k];
                acc[r][0] = fmaf(xv, w0, acc[r][0]);
                acc[r][1] = fmaf(xv, w1, acc[r][1]);
                acc[r][2] = fmaf(xv, w2, acc[r][2]);
                acc[r][3] = fmaf(xv, w3, acc[r][3]);
            }
        }
        for (int k = 0; k < hidden; ++k) {
            const float* uk = ud + static_cast<size_t>(k) * gates;
            const float u0 = uk[j], u1 = uk[hidden + j], u2 = uk[2 * hidden + j];
            const float u3 = uk[3 * hidden + j];
#pragma unroll
            for (int r = 0; r < kFwdRows; ++r) {
                const float hv = h_s[r * hidden + k];
                acc[r][0] = fmaf(hv, u0, acc[r][0]);
                acc[r][1] = fmaf(hv, u1, acc[r][1]);
                acc[r][2] = fmaf(hv, u2, acc[r][2]);
                acc[r][3] = fmaf(hv, u3, acc[r][3]);
            }
        }
        __syncthreads();  // every thread has read x_s and h_s for this step

#pragma unroll
        for (int r = 0; r < kFwdRows; ++r) {
            const float i_g = sigmoid(acc[r][0]);
            const float f_g = sigmoid(acc[r][1]);
            const float g_g = tanhf(acc[r][2]);
            const float o_g = sigmoid(acc[r][3]);
            c[r] = f_g * c[r] + i_g * g_g;
            const float h = o_g * tanhf(c[r]);
            h_s[r * hidden + j] = h;
            const int row = row0 + r;
            if (row < batch) {
                const size_t o = (step_rows + row) * hidden + j;
                h_out[o] = h;
                c_out[o] = c[r];
            }
        }
    }
}

// Row m = t * kBwdRows + r of the tile's A = [x_t | h_{t-1} | 1], column a
// (zero past the last column, for rows past the batch, and for h_{-1}).
__device__ __forceinline__ float a_value(const float* __restrict__ xs,
                                         const float* __restrict__ h_out, int m, int a,
                                         size_t dir_row0, int live_rows, size_t n2, int feat,
                                         int hidden) {
    const int t = m / kBwdRows;
    const int r = m - t * kBwdRows;
    if (r >= live_rows) return 0.0f;
    const size_t row = dir_row0 + r;
    if (a < feat) return xs[(t * n2 + row) * feat + a];
    if (a < feat + hidden) {
        return t > 0 ? h_out[((t - 1) * n2 + row) * hidden + (a - feat)] : 0.0f;
    }
    return a == feat + hidden ? 1.0f : 0.0f;
}

// xs: (T, 2B, F); h_out, c_out, dh_out: (T, 2B, H); wu: (2, F + H, 4H), W
// over U; wut: (2, 4H, F + H), its transpose; b: (2, 4H).
// dgates: (2, gridDim.x, T * kBwdRows, 4H) scratch; partial:
// (2, gridDim.x, F + H + 1, 4H), zero on entry; dx: (T, 2B, F) or null.
// blockDim.x == kThreads, gridDim = (blocks_per_dir, 2).
__global__ void __launch_bounds__(kThreads, 2)
train_bwd(const float* __restrict__ xs, const float* __restrict__ h_out,
          const float* __restrict__ c_out, const float* __restrict__ dh_out,
          const float* __restrict__ wu, const float* __restrict__ wut,
          const float* __restrict__ b, float* __restrict__ dgates,
          float* __restrict__ partial, float* __restrict__ dx,
          int batch, int t_len, int feat, int hidden) {
    extern __shared__ __align__(16) float smem[];
    __shared__ __align__(16) float a_st[kDepth][kWA];  // weight-sum stages
    __shared__ __align__(16) float d_st[kDepth][kWG];
    const int gates = 4 * hidden;
    const int width = feat + hidden;
    const int dir = blockIdx.y;
    const int tid = threadIdx.x;
    const size_t n2 = 2 * static_cast<size_t>(batch);
    float* a_s = smem;                        // (width, kBwdRows): [x_t | h_{t-1}], a-major
    float* g_s = a_s + width * kBwdRows;      // (kBwdRows, 4H): gates, then dgates
    float* dh_s = g_s + kBwdRows * gates;     // (kBwdRows, H): dh carry
    float* dc_s = dh_s + kBwdRows * hidden;   // (kBwdRows, H): dc carry

    const float* wud = wu + static_cast<size_t>(dir) * width * gates;
    const float* wutd = wut + static_cast<size_t>(dir) * gates * width;
    const float* bd = b + dir * gates;
    const size_t slot_index = static_cast<size_t>(dir) * gridDim.x + blockIdx.x;
    float* dg_blk = dgates + slot_index * t_len * kBwdRows * gates;
    float* slot = partial + slot_index * (width + 1) * gates;
    const int tiles = (batch + kBwdRows - 1) / kBwdRows;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int row0 = tile * kBwdRows;
        const int live_rows = min(kBwdRows, batch - row0);
        const size_t dir_row0 = static_cast<size_t>(dir) * batch + row0;
        for (int idx = tid; idx < kBwdRows * hidden; idx += kThreads) {
            dh_s[idx] = 0.0f;
            dc_s[idx] = 0.0f;
        }

        for (int t = t_len - 1; t >= 0; --t) {
            // [x_t | h_{t-1}] of the tile's rows (zero past the batch and at t = 0)
            for (int idx = tid; idx < kBwdRows * width; idx += kThreads) {
                const int r = idx / width;
                const int a = idx - r * width;
                float v = 0.0f;
                if (r < live_rows) {
                    const size_t row = dir_row0 + r;
                    if (a < feat) {
                        v = xs[(t * n2 + row) * feat + a];
                    } else if (t > 0) {
                        v = h_out[((t - 1) * n2 + row) * hidden + (a - feat)];
                    }
                }
                a_s[a * kBwdRows + r] = v;
            }
            __syncthreads();  // a_s filled; the last step's reads of g_s done

            // recompute the gates: one column g per pass, all rows of the tile
            for (int g = tid; g < gates; g += kThreads) {
                float acc[kBwdRows];
                const float bias = bd[g];
#pragma unroll
                for (int r = 0; r < kBwdRows; ++r) acc[r] = bias;
                for (int a = 0; a < width; ++a) {
                    const float wv = wud[static_cast<size_t>(a) * gates + g];
#pragma unroll
                    for (int q = 0; q < kBwdRows / 4; ++q) {
                        const float4 v =
                            *reinterpret_cast<const float4*>(&a_s[a * kBwdRows + 4 * q]);
                        acc[4 * q] = fmaf(v.x, wv, acc[4 * q]);
                        acc[4 * q + 1] = fmaf(v.y, wv, acc[4 * q + 1]);
                        acc[4 * q + 2] = fmaf(v.z, wv, acc[4 * q + 2]);
                        acc[4 * q + 3] = fmaf(v.w, wv, acc[4 * q + 3]);
                    }
                }
#pragma unroll
                for (int r = 0; r < kBwdRows; ++r) g_s[r * gates + g] = acc[r];
            }
            __syncthreads();  // every gate of the step in g_s

            // dgates in place of the gates; the dc carry
            for (int idx = tid; idx < kBwdRows * hidden; idx += kThreads) {
                const int r = idx / hidden;
                const int j = idx - r * hidden;
                float* gr = g_s + r * gates;
                if (r >= live_rows) {
                    gr[j] = gr[hidden + j] = gr[2 * hidden + j] = gr[3 * hidden + j] = 0.0f;
                    continue;
                }
                const size_t at = (t * n2 + dir_row0 + r) * hidden + j;
                const float i_g = sigmoid(gr[j]);
                const float f_g = sigmoid(gr[hidden + j]);
                const float g_g = tanhf(gr[2 * hidden + j]);
                const float o_g = sigmoid(gr[3 * hidden + j]);
                const float c_t = c_out[at];
                const float c_p = t > 0 ? c_out[at - n2 * hidden] : 0.0f;
                const float tanh_c = tanhf(c_t);
                const float dh = dh_out[at] + dh_s[idx];
                const float dcv = dc_s[idx] + dh * o_g * (1.0f - tanh_c * tanh_c);
                gr[j] = dcv * g_g * i_g * (1.0f - i_g);
                gr[hidden + j] = dcv * c_p * f_g * (1.0f - f_g);
                gr[2 * hidden + j] = dcv * i_g * (1.0f - g_g * g_g);
                gr[3 * hidden + j] = dh * tanh_c * o_g * (1.0f - o_g);
                dc_s[idx] = dcv * f_g;
            }
            __syncthreads();  // the step's dgates complete; dh_s reads done

            // [dx_t | dh_carry] = dgates . [W ; U]^T: one column a per pass
            for (int a = tid; a < width; a += kThreads) {
                if (a < feat && dx == nullptr) continue;
                float acc[kBwdRows];
#pragma unroll
                for (int r = 0; r < kBwdRows; ++r) acc[r] = 0.0f;
                for (int k = 0; k < gates; ++k) {
                    const float wv = wutd[static_cast<size_t>(k) * width + a];
#pragma unroll
                    for (int r = 0; r < kBwdRows; ++r) acc[r] = fmaf(g_s[r * gates + k], wv, acc[r]);
                }
                if (a < feat) {
#pragma unroll
                    for (int r = 0; r < kBwdRows; ++r) {
                        if (r < live_rows) dx[(t * n2 + dir_row0 + r) * feat + a] = acc[r];
                    }
                } else {
#pragma unroll
                    for (int r = 0; r < kBwdRows; ++r) dh_s[r * hidden + (a - feat)] = acc[r];
                }
            }
            // the step's dgates to the block's scratch, row m = t * kBwdRows + r
            float* dg_t = dg_blk + static_cast<size_t>(t) * kBwdRows * gates;
            for (int idx = tid; idx < kBwdRows * gates; idx += kThreads) dg_t[idx] = g_s[idx];
        }
        __syncthreads();  // the tile's dgates in scratch

        // slot += A^T . dgates over the tile's T * kBwdRows rows, A = [x | h_{t-1} | 1];
        // thread (ta, tb) keeps an 8 x 8 register tile of each kWA x kWG output tile
        const int rows = t_len * kBwdRows;
        const int ta = tid / 32;
        const int tb = tid % 32;
        for (int a0 = 0; a0 < width + 1; a0 += kWA) {
            for (int g0 = 0; g0 < gates; g0 += kWG) {
                float acc[8][8];
#pragma unroll
                for (int i = 0; i < 8; ++i)
#pragma unroll
                    for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
                for (int m0 = 0; m0 < rows; m0 += kDepth) {
                    // a stage: kDepth x kWA values of A (2 a thread), kDepth x kWG
                    // dgates (2 float4 a thread); rows is a multiple of kDepth
#pragma unroll
                    for (int q = 0; q < 2; ++q) {
                        const int idx = tid + q * kThreads;
                        a_st[idx / kWA][idx % kWA] = a_value(
                            xs, h_out, m0 + idx / kWA, a0 + idx % kWA, dir_row0, live_rows, n2,
                            feat, hidden);
                        const int g = g0 + (idx % (kWG / 4)) * 4;
                        const float4 v = g < gates
                            ? *reinterpret_cast<const float4*>(
                                  dg_blk + static_cast<size_t>(m0 + idx / (kWG / 4)) * gates + g)
                            : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
                        *reinterpret_cast<float4*>(&d_st[idx / (kWG / 4)][(idx % (kWG / 4)) * 4]) = v;
                    }
                    __syncthreads();
                    fma_stage<kWA / 2, kWG / 2>(a_st, d_st, ta, tb, acc);
                    __syncthreads();
                }
                // this thread's outputs: no other thread of any block writes them
#pragma unroll
                for (int i = 0; i < 8; ++i) {
                    const int a = a0 + tile_col(ta, i, kWA / 2);
                    if (a > width) continue;
#pragma unroll
                    for (int j = 0; j < 8; ++j) {
                        const int g = g0 + tile_col(tb, j, kWG / 2);
                        if (g < gates) slot[static_cast<size_t>(a) * gates + g] += acc[i][j];
                    }
                }
            }
        }
    }
}

template <int kFwdRows>
cudaError_t launch_fwd(const void* xs, const void* w, const void* u, const void* b,
                       void* h_out, void* c_out, int batch, int t_len, int feat, int hidden,
                       cudaStream_t stream) {
    const size_t smem = sizeof(float) * kFwdRows * (feat + hidden);
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_dynamic_smem(train_fwd<kFwdRows>, smem);
        if (err != cudaSuccess) return err;
    }
    train_fwd<kFwdRows><<<dim3((batch + kFwdRows - 1) / kFwdRows, 2), dim3(hidden), smem,
                          stream>>>(
        static_cast<const float*>(xs), static_cast<const float*>(w),
        static_cast<const float*>(u), static_cast<const float*>(b),
        static_cast<float*>(h_out), static_cast<float*>(c_out), batch, t_len, feat);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry points for ctypes, float32 only. Each launches on `stream`,
// does not synchronise, and returns the launch error as an int (0: none).

// The forward: h_out and c_out (T, 2B, H) from xs (T, 2B, F).
extern "C" int clair_bilstm_train_fwd(const void* xs, const void* w, const void* u,
                                      const void* b, void* h_out, void* c_out, int batch,
                                      int t_len, int feat, int hidden, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = batch >= kLargeBatch
        ? launch_fwd<kFwdRowsLarge>(xs, w, u, b, h_out, c_out, batch, t_len, feat, hidden, s)
        : launch_fwd<kFwdRowsSmall>(xs, w, u, b, h_out, c_out, batch, t_len, feat, hidden, s);
    return static_cast<int>(err);
}

// The backward: dx (T, 2B, F) unless null, and per block the partial sums
// (F + H + 1) x 4H of dW, dU and db in `partial` (zeroed by the caller).
// tile_rows must equal the kernel's row tile (the caller sizes the dgates
// scratch with it); otherwise cudaErrorInvalidValue.
extern "C" int clair_bilstm_train_bwd(const void* xs, const void* h_out, const void* c_out,
                                      const void* dh_out, const void* wu, const void* wut,
                                      const void* b, void* dgates, void* partial, void* dx,
                                      int batch, int t_len, int feat, int hidden,
                                      int blocks_per_dir, int tile_rows, void* stream) {
    if (tile_rows != kBwdRows || blocks_per_dir < 1) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const size_t smem = sizeof(float) * kBwdRows * (feat + 7 * hidden);
    const cudaError_t err = allow_dynamic_smem(train_bwd, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    train_bwd<<<dim3(blocks_per_dir, 2), dim3(kThreads), smem,
                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(xs), static_cast<const float*>(h_out),
        static_cast<const float*>(c_out), static_cast<const float*>(dh_out),
        static_cast<const float*>(wu), static_cast<const float*>(wut),
        static_cast<const float*>(b), static_cast<float*>(dgates),
        static_cast<float*>(partial), static_cast<float*>(dx), batch, t_len, feat, hidden);
    return static_cast<int>(cudaGetLastError());
}
