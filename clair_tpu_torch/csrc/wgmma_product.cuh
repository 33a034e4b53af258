// A tensor-core product for Hopper (sm_90a) on wgmma fed by TMA: the bf16
// mode of the streaming BiLSTM backward's three products (gate recompute,
// weight sums, dx; bilstm_stream_bwd.cu's Tma*Problem), which replace the
// products inside the TPU kernel clair_tpu/ops/pallas_bilstm_stream.py:
// _bwd_kernel.
//
// What bounds them: at B = 10,000, T = 33, H = 128 they move about 8 GB of
// device memory a train step (the float32 gate buffer, 1.35 GB a layer,
// written by the gate product and, as the sweep's two bf16 dgates pieces,
// read by the weight sums and dx; x and h_out besides): 2.4 ms at
// 3.35 TB/s, against 1.09 ms of bf16 tensor-core operations. Measured
// (tools/torch_bwd_products.py), the gate product is bound by its stores
// and the weight sums and dx by their loads; the products run hidden
// behind them. The design keeps the bytes streaming:
// - operands by TMA (cp.async.bulk.tensor) into a ring of shared-memory
//   stages, each 64 reduction rows deep, every box 64 bf16 values (128
//   bytes) wide in the 128-byte swizzle that wgmma reads; a stage's full
//   barrier (mbarrier) counts its bytes, its empty barrier the consumer
//   warps that have finished reading it. The tensor maps are encoded on
//   the host for each call (pointers change) and passed as
//   __grid_constant__ kernel parameters; whatever a box reaches beyond a
//   tensor's edge arrives as zeros, so ragged rows and widths below 64
//   need no masking.
// - one producer thread keeps the loads in flight; where a problem must
//   zero rows that TMA cannot (h_prev at the sequence edge, rows past a
//   weight-sum chunk), a fix-up warp of the producer warpgroup does it
//   between the bytes' arrival and the consumers' read (fence.proxy.async
//   orders its stores before wgmma's reads).
// - two consumer warpgroups, 64 output rows each, run wgmma.mma_async
//   m64nNk16 (bf16 in, float32 accumulators in registers) straight from
//   the stages, operands whose rows run along the reduction through
//   wgmma's transpose bits; one wgmma group stays in flight while the
//   previous stage is released. setmaxnreg moves registers from the
//   producer warpgroup (40) to the consumers (232), but ptxas compiles the
//   consumers to the launch's 168: a tile of 200 accumulators a thread
//   spilled and serialized its wgmma, so tiles keep to 128 (64 x 256).
// - an epilogue may stage its output in shared memory (the `extra` region)
//   and store it by TMA (tma_store): the gate product's float32 rows leave
//   that way, so its consumers go on to the next tile while the stores
//   drain.
// - side warps (the producer warpgroup's other two, where a problem asks
//   for them) may read each stage beside the consumers on the CUDA cores
//   and release it with them: the weight sums' db, summed in float32 off
//   the consumers' path.
// - persistent blocks, one per SM, walk the output tiles in a fixed order;
//   each tile's reduction runs in a fixed order with no atomics, so two
//   runs give the same bits.
// A problem P supplies the ring's shape (kStages, kStageBytes, kFix,
// kSideWarps, and kExtraBytes of shared memory beside the ring for its
// epilogue), its accumulators (P::Acc: zero() and fence()) and, for one
// output tile: k_steps(tile); stage_bytes(tile); load(tile, k, stage, bar)
// (the producer thread's TMA copies); fix(tile, k, stage, lane) (the fix-up
// warp, where kFix); mma(acc, stage, half, tile) (a consumer warpgroup's
// wgmma of one stage); store(tile, half, acc, extra); where kSideWarps,
// P::Side, side(state, tile, stage, warp, lane) and side_store(state, tile,
// warp, lane) (side warp `warp` of one stage, and its store after the
// tile). tiles() counts the tiles.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from libcuda at run time
#include <dlfcn.h>

#include <cstdint>

#include "lstm_cell.cuh"

namespace {

constexpr int kWgThreads = 384;          // a producer warpgroup and two consumer warpgroups
constexpr int kWgRows = 64;              // output rows of a consumer warpgroup
constexpr int kWgBM = 2 * kWgRows;       // output rows of a tile
constexpr int kWgBK = 64;                // reduction rows of a stage
constexpr int kRowBytes = 128;           // a box row: 64 bf16, the swizzle's span
constexpr int kBoxBytes = kWgBK * kRowBytes;  // a 64 x 64 box
constexpr size_t kWgSmemLimit = 227 * 1024;
constexpr unsigned long long kHangNs = 20ull * 1000 * 1000 * 1000;  // a wait this long is a fault

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
    return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -----------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
                 : "memory");
}
// the producer's arrival, announcing the bytes its copies will complete
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
                 "r"(bytes)
                 : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ bool mbar_try_wait(uint64_t* bar, unsigned parity) {
    unsigned done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    return done != 0;
}
__device__ __forceinline__ unsigned long long global_ns() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    return t;
}
// Wait for the phase of `parity` to complete. A wait that lasts kHangNs
// traps, so a fault in the ring ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
    if (mbar_try_wait(bar, parity)) return;
    const unsigned long long start = global_ns();
    while (!mbar_try_wait(bar, parity))
        if (global_ns() - start > kHangNs) __trap();
}

// ---- TMA -----------------------------------------------------------------

// One box of `map` at coordinates c (innermost first) into shared memory,
// its bytes completing on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1) {
    asm volatile(
        "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
        : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
    asm volatile(
        "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3)
        : "memory");
}

// One box of `map` at coordinates c from shared memory to device memory
// (elements past the tensor's edges are not written), in this thread's
// bulk group.
__device__ __forceinline__ void tma_store(const void* src, const CUtensorMap* map, int c0, int c1,
                                          int c2) {
    asm volatile(
        "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n" ::"l"(
            reinterpret_cast<uint64_t>(map)),
        "r"(smem_u32(src)), "r"(c0), "r"(c1), "r"(c2)
        : "memory");
}
__device__ __forceinline__ void bulk_commit() {
    asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// At most `Pending` of this thread's bulk groups still read shared memory.
template <int Pending>
__device__ __forceinline__ void bulk_wait_read() {
    asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(Pending) : "memory");
}
// A barrier of `threads` threads on barrier `id` (1.., 0 is __syncthreads).
__device__ __forceinline__ void named_barrier(int id, int threads) {
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Zero row r (128 bytes) of a box in shared memory. The swizzle permutes
// 16-byte chunks within a row, so a row stays whole.
__device__ __forceinline__ void zero_row(unsigned char* box, int r) {
    uint4* row = reinterpret_cast<uint4*>(box + r * kRowBytes);
#pragma unroll
    for (int c = 0; c < kRowBytes / 16; ++c) row[c] = make_uint4(0u, 0u, 0u, 0u);
}

// A 32-bit load from shared memory (a shared-window address).
__device__ __forceinline__ uint32_t ld_shared_b32(uint32_t addr) {
    uint32_t v;
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
    return v;
}
// The two bf16 of a 32-bit word as float32 (exact: a bf16 is a float32's
// high half).
__device__ __forceinline__ float2 bf16x2_float2(uint32_t v) {
    return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xFFFF0000u));
}

// Shared-memory stores of this thread before wgmma (the async proxy)
// reads them.
__device__ __forceinline__ void fence_proxy_async() {
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- wgmma ---------------------------------------------------------------

// A shared-memory matrix descriptor in the 128-byte swizzle: start address,
// leading byte offset (lbo) and stride byte offset (sbo), each in 16-byte
// units. K-major tiles (rows along the output, 64 reduction values a
// 128-byte row): sbo = 1024, the next 8 rows; lbo unused. MN-major tiles
// (rows along the reduction, 64 output values a row): sbo = 1024, the next
// 8 reduction rows; lbo the next 64 output values (the next box). Tiles
// start on 1024-byte boundaries, so the base offset is 0.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
           (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
           (1ull << 62);
}
__device__ __forceinline__ uint64_t k_major_desc(uint32_t addr) { return wgmma_desc(addr, 16, 1024); }
__device__ __forceinline__ uint64_t mn_major_desc(uint32_t addr) {
    return wgmma_desc(addr, kBoxBytes, 1024);
}
// The descriptors of reduction step kk (16 deep) of a stage: K-major moves
// 32 bytes along its rows, MN-major 16 rows down.
__device__ __forceinline__ uint64_t k_major_at(uint32_t addr, int kk) {
    return k_major_desc(addr + kk * 32);
}
__device__ __forceinline__ uint64_t mn_major_at(uint32_t addr, int kk) {
    return mn_major_desc(addr + kk * 16 * kRowBytes);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() {
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int Pending>
__device__ __forceinline__ void wgmma_wait() {
    asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(Pending) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void zero_acc(float (&d)[N]) {
#pragma unroll
    for (int i = 0; i < N; ++i) d[i] = 0.0f;
}
// A consumer thread's accumulators of an m64nNk16 tile.
template <int N>
struct WgmmaAcc {
    float d[N / 2];
    __device__ __forceinline__ void zero() { zero_acc(d); }
    __device__ __forceinline__ void fence() { fence_acc(d); }
};

// d (64 x N, float32, the m64nNk16 fragment) += A (64 x 16) . B (16 x N),
// bf16 from shared memory through descriptors a and b; TA / TB 1 where the
// operand's rows run along the reduction (MN-major). Fragment: thread
// 32w + l of the warpgroup holds rows 16w + l/4 (+ 8) and columns
// 8j + 2(l%4) (+ 1) as d[4j .. 4j + 3].
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n192(float (&d)[96], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %98, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n192k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95"
        "}, %96, %97, p, 1, 1, %99, %100;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n256(float (&d)[128], uint64_t a, uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
        "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
        "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
        "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
          "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
          "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
          "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
          "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
          "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
          "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(1), "n"(TA), "n"(TB));
}

// The m64nNk16 product of the width a problem's tile takes.
template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2], uint64_t a, uint64_t b) {
    static_assert(N == 192 || N == 256, "no wrapper for this width");
    if constexpr (N == 192) wgmma_n192<TA, TB>(d, a, b);
    else wgmma_n256<TA, TB>(d, a, b);
}

// ---- the kernel ------------------------------------------------------------

template <class P>
struct WgmmaLayout {
    static constexpr size_t kRing = static_cast<size_t>(P::kStages) * P::kStageBytes;
    static constexpr size_t kExtra = P::kExtraBytes;  // a problem's epilogue region (1024-aligned)
    static constexpr size_t kBars = 3 * P::kStages * sizeof(uint64_t);
    static constexpr size_t kBytes = 1024 + kRing + kExtra + kBars;  // 1024: the base's alignment
};

template <class P>
__global__ void __launch_bounds__(kWgThreads, 1) wgmma_product(const __grid_constant__ P p) {
    using L = WgmmaLayout<P>;
    static_assert(P::kSideWarps >= 0 && P::kSideWarps <= 2, "warps 2 and 3 of the producer warpgroup");
    // (named apart from the including file's kernels' dynamic shared memory)
    extern __shared__ __align__(1024) unsigned char wgmma_smem[];
    unsigned char* ring = wgmma_smem + ((1024 - (smem_u32(wgmma_smem) & 1023)) & 1023);
    unsigned char* extra = ring + L::kRing;
    uint64_t* full = reinterpret_cast<uint64_t*>(extra + L::kExtra);
    uint64_t* ready = full + P::kStages;   // after the fix-up (kFix), else unused
    uint64_t* empty = ready + P::kStages;
    const int wg = threadIdx.x / 128, warp = threadIdx.x / 32, lane = threadIdx.x & 31;
    if (threadIdx.x == 0) {
        for (int s = 0; s < P::kStages; ++s) {
            mbar_init(&full[s], 1);
            mbar_init(&ready[s], 1);
            mbar_init(&empty[s], 8 + P::kSideWarps);  // every consumer and side warp
        }
        asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    }
    __syncthreads();
    const int tiles = p.tiles();

    if (wg == 0) {
        asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
        if (warp == 0 && lane == 0) {
            // the producer: one stage at a time, once its consumers released it
            int stage = 0;
            unsigned phase = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int steps = p.k_steps(tile);
                const unsigned bytes = p.stage_bytes(tile);
                for (int k = 0; k < steps; ++k) {
                    mbar_wait(&empty[stage], phase ^ 1);
                    mbar_expect_tx(&full[stage], bytes);
                    p.load(tile, k, ring + stage * P::kStageBytes, &full[stage]);
                    if (++stage == P::kStages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        } else if (warp == 1) {
            // the fix-up warp: the rows TMA cannot zero, between arrival and use
            if constexpr (!P::kFix) return;
            int stage = 0;
            unsigned phase = 0;
            for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                const int steps = p.k_steps(tile);
                for (int k = 0; k < steps; ++k) {
                    mbar_wait(&full[stage], phase);
                    p.fix(tile, k, ring + stage * P::kStageBytes, lane);
                    fence_proxy_async();
                    __syncwarp();
                    if (lane == 0) mbar_arrive(&ready[stage]);
                    if (++stage == P::kStages) {
                        stage = 0;
                        phase ^= 1;
                    }
                }
            }
        } else if (warp >= 2 && warp - 2 < P::kSideWarps) {
            // a side warp: each stage once its bytes (and fix-up) are in,
            // released with the consumers
            if constexpr (P::kSideWarps > 0) {
                uint64_t* arrived = P::kFix ? ready : full;
                int stage = 0;
                unsigned phase = 0;
                for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
                    typename P::Side state{};
                    const int steps = p.k_steps(tile);
                    for (int k = 0; k < steps; ++k) {
                        mbar_wait(&arrived[stage], phase);
                        p.side(state, tile, ring + stage * P::kStageBytes, warp - 2, lane);
                        __syncwarp();  // every lane's reads are done
                        if (lane == 0) mbar_arrive(&empty[stage]);
                        if (++stage == P::kStages) {
                            stage = 0;
                            phase ^= 1;
                        }
                    }
                    p.side_store(state, tile, warp - 2, lane);
                }
            }
        }
    } else {
        asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
        const int half = wg - 1;  // this warpgroup's 64 rows of the tile
        uint64_t* arrived = P::kFix ? ready : full;
        int stage = 0;
        unsigned phase = 0;
        for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
            typename P::Acc acc;
            acc.zero();
            const int steps = p.k_steps(tile);
            int prev = -1;
            for (int k = 0; k < steps; ++k) {
                mbar_wait(&arrived[stage], phase);
                acc.fence();
                wgmma_fence();
                p.mma(acc, ring + stage * P::kStageBytes, half, tile);
                wgmma_commit();
                // the previous stage's products are done: release it
                wgmma_wait<1>();
                acc.fence();
                if (prev >= 0 && lane == 0) mbar_arrive(&empty[prev]);
                prev = stage;
                if (++stage == P::kStages) {
                    stage = 0;
                    phase ^= 1;
                }
            }
            wgmma_wait<0>();
            acc.fence();
            if (lane == 0) mbar_arrive(&empty[prev]);
            p.store(tile, half, acc, extra);
        }
        asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");  // a problem's TMA stores
    }
}

// ---- host: tensor maps and the launch ----------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, from the libcuda.so.1 the runtime has
// loaded (no link against libcuda).
EncodeTiled encode_tiled() {
    static EncodeTiled fn = [] {
        void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
        if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
        return lib == nullptr ? nullptr
                              : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
    }();
    return fn;
}

// A tensor map of rank R in the 128-byte swizzle: dims innermost first, the
// byte strides of dims 1.., and the box. Out-of-bounds elements load as
// zeros and are not stored.
template <int R>
cudaError_t tensor_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                       const cuuint64_t (&dims)[R], const cuuint64_t (&strides)[R - 1],
                       const cuuint32_t (&box)[R]) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    cuuint32_t unit[R];
    for (int i = 0; i < R; ++i) unit[i] = 1;
    const CUresult r = encode(map, type, R, const_cast<void*>(base),
                              dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}
template <int R>
cudaError_t bf16_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
                     const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R]) {
    return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, base, dims, strides, box);
}

int sm_count() {
    int device = 0, sms = 0;
    if (cudaGetDevice(&device) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess)
        return 0;
    return sms;
}

// One persistent block a multiprocessor (at most one a tile). The launch
// gives each of its 384 threads 168 registers; setmaxnreg moves them to
// 40 a producer thread and 232 a consumer thread.
template <class P>
cudaError_t launch_wgmma(const P& p, int tiles, cudaStream_t stream) {
    constexpr size_t smem = WgmmaLayout<P>::kBytes;
    static_assert(smem <= kWgSmemLimit, "the product's ring exceeds shared memory");
    static_assert(P::kStageBytes % 1024 == 0 && P::kExtraBytes % 1024 == 0,
                  "stages keep the swizzle's 1024-byte alignment");
    const int sms = sm_count();
    if (sms <= 0) return cudaErrorInvalidDevice;
    if (tiles <= 0) return cudaSuccess;
    const cudaError_t err = allow_dynamic_smem(wgmma_product<P>, smem);
    if (err != cudaSuccess) return err;
    wgmma_product<P><<<tiles < sms ? tiles : sms, kWgThreads, smem, stream>>>(p);
    return cudaGetLastError();
}

}  // namespace
