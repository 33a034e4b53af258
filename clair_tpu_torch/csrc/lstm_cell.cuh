// Device helpers shared by the port's LSTM kernels: element loads as float,
// stores from float, the gate nonlinearity, the tensor-core building blocks
// (cp.async, ldmatrix, mma.sync m16n8k16 bf16) and the split cluster
// barrier of the two cluster forwards (bilstm_stream_fwd.cu, lstm_sweep.cuh)
// and both backwards.
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

// The streaming pair's gate nonlinearities: float32 takes the accurate expf
// and tanhf (the forward's bound against the plain version is 2e-6); bf16,
// whose h is rounded to 2^-8 every step, the hardware tanh (relative error
// 2^-11), with sigmoid(v) = tanh(v / 2) / 2 + 1 / 2.
__device__ __forceinline__ float tanh_approx(float v) {
    float r;
    asm("tanh.approx.f32 %0, %1;" : "=f"(r) : "f"(v));
    return r;
}
template <typename T>
__device__ __forceinline__ float gate_tanh(float v) {
    if constexpr (sizeof(T) == 2) return tanh_approx(v);
    else return tanhf(v);
}
template <typename T>
__device__ __forceinline__ float gate_sigmoid(float v) {
    if constexpr (sizeof(T) == 2) return fmaf(0.5f, tanh_approx(0.5f * v), 0.5f);
    else return sigmoid(v);
}

// 16 bytes from device memory into shared memory, asynchronously; with
// src == nullptr the 16 bytes are zero-filled (nothing is read from `any`,
// which only has to be a device address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async16_or_zero(void* smem, const void* src, const void* any) {
    const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                 ::"r"(s), "l"(src != nullptr ? src : any), "r"(src != nullptr ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::); }
// all but the newest `Pending` committed groups have landed
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending));
}

// ldmatrix: 8 x 8 tiles of 16-bit values from shared memory, one row
// address per lane (lanes 0-7 the first tile, 8-15 the second, ...); the
// .trans forms deliver each tile transposed.
__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const void* p) {
    const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
    asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
                 : "=r"(r[0]), "=r"(r[1])
                 : "r"(a));
}
// d += a (16 x 16, row) * b (16 x 8, col), bf16 operands, float32 sums
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The two halves of a thread-block cluster's barrier, split so that work
// that needs no peer can run between them: arrive releases this thread's
// earlier writes (shared memory of peers included), wait acquires every
// peer's.
__device__ __forceinline__ void cluster_arrive() {
    asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
    asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Let `kernel` take `bytes` of dynamic shared memory (above 48 KB only after
// this opt-in).
template <typename Kernel>
cudaError_t allow_dynamic_smem(Kernel kernel, size_t bytes) {
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                static_cast<int>(bytes));
}

}  // namespace
