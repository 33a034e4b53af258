// Device helpers shared by the port's LSTM kernels: element loads as float,
// stores from float, the gate nonlinearity, and the 8 x 8 register-tiled
// product stage of the weight-gradient sums.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_float(float v);
template <> __device__ __forceinline__ float from_float<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
    return __float2bfloat16(v);
}

__device__ __forceinline__ float sigmoid(float v) { return 1.0f / (1.0f + expf(-v)); }

// rows of the reduction per stage of fma_stage
constexpr int kDepth = 8;

// One stage of an 8 x 8 register-tiled product: acc[i][j] += a[i] * b[j]
// over the kDepth rows of two shared tiles (row pitches PA, PB). Thread
// (ta, tb) owns columns ta*4..+3 and HA + ta*4..+3 of a_s, and tb*4..+3 and
// HB + tb*4..+3 of b_s: each read is a float4, and the lanes of a warp read
// one broadcast line or consecutive lines, without bank conflicts.
template <int HA, int HB, int PA, int PB>
__device__ __forceinline__ void fma_stage(const float (*a_s)[PA], const float (*b_s)[PB],
                                          int ta, int tb, float (&acc)[8][8]) {
#pragma unroll
    for (int kk = 0; kk < kDepth; ++kk) {
        const float4 a_lo = *reinterpret_cast<const float4*>(&a_s[kk][ta * 4]);
        const float4 a_hi = *reinterpret_cast<const float4*>(&a_s[kk][HA + ta * 4]);
        const float4 b_lo = *reinterpret_cast<const float4*>(&b_s[kk][tb * 4]);
        const float4 b_hi = *reinterpret_cast<const float4*>(&b_s[kk][HB + tb * 4]);
        const float av[8] = {a_lo.x, a_lo.y, a_lo.z, a_lo.w, a_hi.x, a_hi.y, a_hi.z, a_hi.w};
        const float bv[8] = {b_lo.x, b_lo.y, b_lo.z, b_lo.w, b_hi.x, b_hi.y, b_hi.z, b_hi.w};
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
}

// the column an 8 x 8 tile's index i (or j) stands for: 4 from each half
__device__ __forceinline__ int tile_col(int t, int i, int half) {
    return i < 4 ? t * 4 + i : half + t * 4 + (i - 4);
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB only after
// this opt-in).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace
