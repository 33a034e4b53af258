// Backward of one bidirectional LSTM layer, both directions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel clair_tpu/ops/pallas_bilstm_stream.py:_bwd_kernel
// (reached through _bwd_pallas and _bilstm_bwd). Same math: a reverse sweep
// over time that recomputes the gates from x_t and h_prev (products of
// input-type values accumulated in float32, as the forward does), carries
// dh and dc in float32, and forms
//   dgates = [dc*g*i(1-i), dc*c_prev*f(1-f), dc*i(1-g^2), dh*tanh(c)*o(1-o)]
// with dh = dh_out_t + dh_carry, dc = dc_carry + dh*o*(1 - tanh^2 c),
// dh_carry = dgates.U^T and dc_carry = dc*f. From the dgates it gives
// dx = sum over directions of dgates.W^T (in the input type) and the float32
// sums dW = x^T.dgates, dU = h_prev^T.dgates and db = sum of dgates.
//
// Time indexing: the forward kernel keeps the backward direction at its
// original time index (bilstm_stream_fwd.cu), so here direction 0 sweeps
// t = T-1 .. 0 with h_prev = h_out[:, t-1, :H], and direction 1 sweeps
// t = 0 .. T-1 with h_prev = h_out[:, t+1, H:]. The missing neighbour at the
// sequence edge is the zero initial state (the TPU kernel masks the same
// fetch, pallas_bilstm_stream.py:97-101).
//
// What bounds it, and the design:
// - The sweep is serial in t, like the forward, and bound like it by
//   re-reading W, U and U^T (from L2) every step, one value per kRows FMAs:
//   one block per (tile of kRows rows, direction), one thread per hidden unit,
//   x_t / h_prev / dh_carry / this step's dgates in shared memory (dh_carry
//   needs every gate of a row), dc_carry in registers. It writes the step's
//   float32 dgates to a (2, B, T, 4H) buffer in device memory (1.35 GB at
//   B = 10,000): the TPU kernel adds x^T.dgates into VMEM-resident output
//   blocks per tile, but here blocks run in no order and a per-tile partial
//   of (F + H + 1) x 4H floats would cost ~3.9 GB at that batch, and atomics
//   would make the sums' order change from run to run.
// - The weight sums are a second kernel: a tiled A^T.D product over the
//   B*T rows, with A = [x | h_prev] per direction (db from the same staged
//   rows), split along the rows into a fixed number of chunks whose float32
//   partials the caller adds in a fixed order. Deterministic; 2 directions
//   x 2*(F+H)*4H*B*T FLOPs (260 GFLOP for lstm2 at B = 10,000).
// - dx is a third kernel: a tiled product of the dgates of both directions
//   (B*T x 8H) with [W_0 ; W_1]^T, written once in the input type.
// - Both products keep an 8 x 8 register tile per thread (16 shared-memory
//   floats read per 64 FMAs) and stage the next rows in registers while the
//   current ones are multiplied, from two shared buffers.
// Float32 FMA throughout; no tensor cores (wgmma), TMA or cp.async yet.

#include "lstm_cell.cuh"

namespace {

// batch rows per sweep block, as the forward kernel's row tile: on an H100,
// 8 rows ran 3-10% faster at B = 10,000 and 40-70% slower at B = 512
constexpr int kRows = 4;
// the two product kernels: 256 threads each owning an 8 x 8 register tile,
// kDepth (lstm_cell.cuh) rows of the reduction per stage; weight sums in
// tiles of kWA columns of A by kWG gates, dx in tiles of kDX rows by kDX
// features
constexpr int kThreads = 256;
constexpr int kWA = 64;
constexpr int kWG = 256;
constexpr int kDX = 128;

// (a) The reverse sweep. x: (batch, t_len, feat); w: (2, feat, 4H);
// u: (2, H, 4H); ut: (2, 4H, H), u transposed; b: (2, 4H) float32;
// h_out, dh_out: (batch, t_len, 2H) in T; c_out: the same shape in float32.
// dgates: (2, batch, t_len, 4H) float32, written for every real row.
// blockDim.x == H, gridDim = (ceil(batch / kRows), 2).
template <typename T>
__global__ void bilstm_bwd_sweep(const T* __restrict__ x, const T* __restrict__ w,
                                 const T* __restrict__ u, const T* __restrict__ ut,
                                 const float* __restrict__ b, const T* __restrict__ h_out,
                                 const float* __restrict__ c_out,
                                 const T* __restrict__ dh_out, float* __restrict__ dgates,
                                 int batch, int t_len, int feat) {
    extern __shared__ float smem[];
    const int hidden = blockDim.x;
    const int gates = 4 * hidden;
    const int j = threadIdx.x;
    const int dir = blockIdx.y;
    const int row0 = blockIdx.x * kRows;
    float* x_s = smem;                    // (kRows, feat): x_t
    float* h_s = x_s + kRows * feat;      // (kRows, H): h_prev, as T values
    float* dh_s = h_s + kRows * hidden;   // (kRows, H): dh_carry
    float* dg_s = dh_s + kRows * hidden;  // (kRows, 4H): this step's dgates

    const T* wd = w + static_cast<size_t>(dir) * feat * gates;
    const T* ud = u + static_cast<size_t>(dir) * hidden * gates;
    const T* utd = ut + static_cast<size_t>(dir) * gates * hidden;
    const float* bd = b + dir * gates;
    const float b_i = bd[j], b_f = bd[hidden + j];
    const float b_g = bd[2 * hidden + j], b_o = bd[3 * hidden + j];
    const size_t row_stride = static_cast<size_t>(t_len) * 2 * hidden;  // h_out, c_out, dh_out

    float dc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
        dc[r] = 0.0f;
        dh_s[r * hidden + j] = 0.0f;
    }

    for (int step = 0; step < t_len; ++step) {
        const int t = dir == 0 ? t_len - 1 - step : step;
        const int tp = dir == 0 ? t - 1 : t + 1;
        const bool has_prev = tp >= 0 && tp < t_len;
        for (int idx = j; idx < kRows * feat; idx += hidden) {
            const int r = idx / feat;
            const int k = idx - r * feat;
            const int row = row0 + r;
            x_s[idx] = row < batch
                ? to_float(x[(static_cast<size_t>(row) * t_len + t) * feat + k])
                : 0.0f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int row = row0 + r;
            h_s[r * hidden + j] = row < batch && has_prev
                ? to_float(h_out[row * row_stride + static_cast<size_t>(tp) * 2 * hidden +
                                 dir * hidden + j])
                : 0.0f;
        }
        __syncthreads();  // x_s, h_s filled; last step's dg_s reads done

        // recompute this step's gates, as the forward kernel does
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

#pragma unroll
        for (int r = 0; r < kRows; ++r) {
            const int row = row0 + r;
            const bool live = row < batch;
            const size_t at = live
                ? row * row_stride + static_cast<size_t>(t) * 2 * hidden + dir * hidden + j
                : 0;
            const float i_g = sigmoid(acc[r][0]);
            const float f_g = sigmoid(acc[r][1]);
            const float g_g = tanhf(acc[r][2]);
            const float o_g = sigmoid(acc[r][3]);
            const float c_t = live ? c_out[at] : 0.0f;
            const float c_p = live && has_prev
                ? c_out[row * row_stride + static_cast<size_t>(tp) * 2 * hidden + dir * hidden + j]
                : 0.0f;
            const float tanh_c = tanhf(c_t);
            const float dh = (live ? to_float(dh_out[at]) : 0.0f) + dh_s[r * hidden + j];
            const float dcv = dc[r] + dh * o_g * (1.0f - tanh_c * tanh_c);
            const float d_i = dcv * g_g * i_g * (1.0f - i_g);
            const float d_f = dcv * c_p * f_g * (1.0f - f_g);
            const float d_g = dcv * i_g * (1.0f - g_g * g_g);
            const float d_o = dh * tanh_c * o_g * (1.0f - o_g);
            dc[r] = dcv * f_g;
            float* dgr = dg_s + r * gates;
            dgr[j] = d_i;
            dgr[hidden + j] = d_f;
            dgr[2 * hidden + j] = d_g;
            dgr[3 * hidden + j] = d_o;
            if (live) {
                float* out = dgates +
                    ((static_cast<size_t>(dir) * batch + row) * t_len + t) * gates;
                out[j] = d_i;
                out[hidden + j] = d_f;
                out[2 * hidden + j] = d_g;
                out[3 * hidden + j] = d_o;
            }
        }
        __syncthreads();  // dg_s complete; every read of x_s and h_s done

        // dh_carry[r][j] = sum_k dgates[r][k] * U[j][k], U^T read coalesced
        float carry[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) carry[r] = 0.0f;
        for (int k = 0; k < gates; ++k) {
            const float uv = to_float(utd[static_cast<size_t>(k) * hidden + j]);
#pragma unroll
            for (int r = 0; r < kRows; ++r) carry[r] = fmaf(dg_s[r * gates + k], uv, carry[r]);
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) dh_s[r * hidden + j] = carry[r];
    }
}

// Row m = b*T + t of A = [x | h_prev] for direction dir, column a (zero
// past the last column).
template <typename T>
__device__ __forceinline__ float a_value(const T* __restrict__ x, const T* __restrict__ h_out,
                                         size_t m, int a, int dir, int t_len, int feat,
                                         int hidden) {
    if (a < feat) return to_float(x[m * feat + a]);
    if (a >= feat + hidden) return 0.0f;
    const size_t bi = m / t_len;
    const int t = static_cast<int>(m - bi * t_len);
    const int tp = dir == 0 ? t - 1 : t + 1;
    if (tp < 0 || tp >= t_len) return 0.0f;
    return to_float(h_out[(bi * t_len + tp) * 2 * hidden + dir * hidden + (a - feat)]);
}

// Four consecutive values as floats (p aligned to 16 bytes for float, 8 for
// bfloat16).
__device__ __forceinline__ float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// (b) Weight sums. partial[split][dir] is (F + H + 1) x 4H float32: row a
// < F + H is the sum over the chunk's rows m of A_dir[m][a] *
// dgates[dir][m] with A = [x | h_prev]; row F + H is the chunk's sum of
// dgates (db), added up by warp 0 of the blocks of the first A tile from
// the rows they stage anyway. Rows are staged kDepth at a time into one of
// two shared buffers while the other is multiplied (the next stage's loads
// are in flight in registers during the products).
// gridDim = (ceil(4H / kWG), ceil((F + H) / kWA), splits * 2); kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_weights(const T* __restrict__ x, const T* __restrict__ h_out,
                   const float* __restrict__ dgates, float* __restrict__ partial,
                   int batch, int t_len, int feat, int hidden, int rows_per_split) {
    __shared__ __align__(16) float a_s[2][kDepth][kWA];
    __shared__ __align__(16) float d_s[2][kDepth][kWG];
    const int gates = 4 * hidden;
    const int width = feat + hidden;
    const int g0 = blockIdx.x * kWG;
    const int a0 = blockIdx.y * kWA;
    const int dir = blockIdx.z & 1;
    const int split = blockIdx.z >> 1;
    const size_t rows = static_cast<size_t>(batch) * t_len;
    const size_t m_begin = static_cast<size_t>(split) * rows_per_split;
    const size_t m_end = min(rows, m_begin + rows_per_split);
    const int tid = threadIdx.x;
    const int ta = tid / 32;  // 8 x 32 threads: a warp shares its A columns
    const int tb = tid % 32;
    const bool sums_db = blockIdx.y == 0 && ta == 0;
    const float* dg = dgates + static_cast<size_t>(dir) * rows * gates;

    float acc[8][8];
    float db[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        db[i] = 0.0f;
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    }

    // a stage: kDepth x kWA values of A (2 a thread), kDepth x kWG of
    // dgates (2 float4 a thread)
    float a_r[2];
    float4 d_r[2];
    auto fetch = [&](size_t m0) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int idx = tid + q * kThreads;
            const size_t m = m0 + idx / kWA;
            a_r[q] = m < m_end
                ? a_value(x, h_out, m, a0 + idx % kWA, dir, t_len, feat, hidden) : 0.0f;
            const size_t md = m0 + idx / (kWG / 4);
            const int g = g0 + (idx % (kWG / 4)) * 4;
            d_r[q] = md < m_end && g < gates
                ? *reinterpret_cast<const float4*>(dg + md * gates + g)
                : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        }
    };
    auto stash = [&](int buf) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const int idx = tid + q * kThreads;
            a_s[buf][idx / kWA][idx % kWA] = a_r[q];
            *reinterpret_cast<float4*>(&d_s[buf][idx / (kWG / 4)][(idx % (kWG / 4)) * 4]) =
                d_r[q];
        }
    };

    int buf = 0;
    if (m_begin < m_end) {
        fetch(m_begin);
        stash(0);
    }
    __syncthreads();
    for (size_t m0 = m_begin; m0 < m_end; m0 += kDepth) {
        const bool more = m0 + kDepth < m_end;
        if (more) fetch(m0 + kDepth);
        fma_stage<kWA / 2, kWG / 2>(a_s[buf], d_s[buf], ta, tb, acc);
        if (sums_db) {
#pragma unroll
            for (int kk = 0; kk < kDepth; ++kk)
#pragma unroll
                for (int j = 0; j < 8; ++j) db[j] += d_s[buf][kk][tile_col(tb, j, kWG / 2)];
        }
        if (more) stash(buf ^ 1);
        __syncthreads();
        buf ^= 1;
    }

    float* out = partial + static_cast<size_t>(split * 2 + dir) * (width + 1) * gates;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const int a = a0 + tile_col(ta, i, kWA / 2);
        if (a >= width) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int g = g0 + tile_col(tb, j, kWG / 2);
            if (g < gates) out[static_cast<size_t>(a) * gates + g] = acc[i][j];
        }
    }
    if (sums_db) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int g = g0 + tile_col(tb, j, kWG / 2);
            if (g < gates) out[static_cast<size_t>(width) * gates + g] = db[j];
        }
    }
}

// (c) dx[m][f] = sum over dir, g of dgates[dir][m][g] * W[dir][f][g], in T.
// Both operands run along the reduction (the 8H gates of both directions),
// so each thread stages 4 consecutive gates of one row of each tile and
// stores them transposed; rows are padded by 4 floats so the two threads
// of a row write to different banks. Needs 4H % 8 == 0 (H even), so a
// stage never straddles the two directions.
// gridDim = (ceil(feat / kDX), ceil(B*T / kDX)); kThreads.
template <typename T>
__global__ void __launch_bounds__(kThreads)
bilstm_bwd_dx(const float* __restrict__ dgates, const T* __restrict__ w, T* __restrict__ dx,
              int batch, int t_len, int feat, int hidden) {
    __shared__ __align__(16) float d_s[2][kDepth][kDX + 4];
    __shared__ __align__(16) float w_s[2][kDepth][kDX + 4];
    const int gates = 4 * hidden;
    const int depth = 2 * gates;
    const size_t rows = static_cast<size_t>(batch) * t_len;
    const int f0 = blockIdx.x * kDX;
    const size_t m0 = static_cast<size_t>(blockIdx.y) * kDX;
    const int tid = threadIdx.x;
    const int tm = tid / 16;  // 16 x 16 threads
    const int tf = tid % 16;
    const int r = tid / 2;          // the tile row this thread stages
    const int k4 = (tid % 2) * 4;   // and which 4 of the stage's 8 gates

    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;

    float4 d_r, w_r;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    auto fetch = [&](int k0) {
        const int k = k0 + k4;
        const int dir = k >= gates;
        const int g = k - dir * gates;
        const size_t m = m0 + r;
        const int f = f0 + r;
        d_r = m < rows ? load4(dgates + (static_cast<size_t>(dir) * rows + m) * gates + g) : zero;
        w_r = f < feat ? load4(w + (static_cast<size_t>(dir) * feat + f) * gates + g) : zero;
    };
    auto stash = [&](int buf) {
        d_s[buf][k4][r] = d_r.x;
        d_s[buf][k4 + 1][r] = d_r.y;
        d_s[buf][k4 + 2][r] = d_r.z;
        d_s[buf][k4 + 3][r] = d_r.w;
        w_s[buf][k4][r] = w_r.x;
        w_s[buf][k4 + 1][r] = w_r.y;
        w_s[buf][k4 + 2][r] = w_r.z;
        w_s[buf][k4 + 3][r] = w_r.w;
    };

    int buf = 0;
    fetch(0);
    stash(0);
    __syncthreads();
    for (int k0 = 0; k0 < depth; k0 += kDepth) {
        const bool more = k0 + kDepth < depth;
        if (more) fetch(k0 + kDepth);
        fma_stage<kDX / 2, kDX / 2>(d_s[buf], w_s[buf], tm, tf, acc);
        if (more) stash(buf ^ 1);
        __syncthreads();
        buf ^= 1;
    }

#pragma unroll
    for (int i = 0; i < 8; ++i) {
        const size_t m = m0 + tile_col(tm, i, kDX / 2);
        if (m >= rows) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
            const int f = f0 + tile_col(tf, j, kDX / 2);
            if (f < feat) dx[m * feat + f] = from_float<T>(acc[i][j]);
        }
    }
}

template <typename T>
cudaError_t launch(const void* x, const void* w, const void* u, const void* ut, const void* b,
                   const void* h_out, const void* c_out, const void* dh_out, void* dgates,
                   void* partial, void* dx, int batch, int t_len, int feat, int hidden,
                   int splits, int rows_per_split, cudaStream_t stream) {
    const size_t smem = sizeof(float) * kRows * (feat + 6 * hidden);
    if (smem > 48 * 1024) {
        const cudaError_t err = allow_dynamic_smem(bilstm_bwd_sweep<T>, smem);
        if (err != cudaSuccess) return err;
    }
    bilstm_bwd_sweep<T><<<dim3((batch + kRows - 1) / kRows, 2), dim3(hidden), smem, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(u),
        static_cast<const T*>(ut), static_cast<const float*>(b),
        static_cast<const T*>(h_out), static_cast<const float*>(c_out),
        static_cast<const T*>(dh_out), static_cast<float*>(dgates), batch, t_len, feat);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;

    const int gates = 4 * hidden;
    bilstm_bwd_weights<T><<<dim3((gates + kWG - 1) / kWG, (feat + hidden + kWA - 1) / kWA,
                                 splits * 2),
                            dim3(kThreads), 0, stream>>>(
        static_cast<const T*>(x), static_cast<const T*>(h_out),
        static_cast<const float*>(dgates), static_cast<float*>(partial), batch, t_len, feat,
        hidden, rows_per_split);
    err = cudaGetLastError();
    if (err != cudaSuccess || dx == nullptr) return err;

    const size_t rows = static_cast<size_t>(batch) * t_len;
    bilstm_bwd_dx<T><<<dim3((feat + kDX - 1) / kDX,
                            static_cast<unsigned>((rows + kDX - 1) / kDX)),
                       dim3(kThreads), 0, stream>>>(
        static_cast<const float*>(dgates), static_cast<const T*>(w), static_cast<T*>(dx),
        batch, t_len, feat, hidden);
    return cudaGetLastError();
}

}  // namespace

// Plain C entry point for ctypes. is_bf16 selects the element type of x, w,
// u, ut, h_out, dh_out and dx (0: float32, 1: bfloat16); b, c_out, dgates
// and partial are float32. partial holds splits * 2 * (F + H + 1) * 4H
// floats, chunk `split` covering rows [split * rows_per_split, ...) of the
// B*T rows; dx may be null (no input gradient). hidden must be even.
// Launches on `stream`, does not synchronise, and returns the first launch
// error as an int (0: none).
extern "C" int clair_bilstm_stream_bwd(const void* x, const void* w, const void* u,
                                       const void* ut, const void* b, const void* h_out,
                                       const void* c_out, const void* dh_out, void* dgates,
                                       void* partial, void* dx, int batch, int t_len,
                                       int feat, int hidden, int splits, int rows_per_split,
                                       int is_bf16, void* stream) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t err = is_bf16
        ? launch<__nv_bfloat16>(x, w, u, ut, b, h_out, c_out, dh_out, dgates, partial, dx,
                                batch, t_len, feat, hidden, splits, rows_per_split, s)
        : launch<float>(x, w, u, ut, b, h_out, c_out, dh_out, dgates, partial, dx, batch,
                        t_len, feat, hidden, splits, rows_per_split, s);
    return static_cast<int>(err);
}
