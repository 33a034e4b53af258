// Clair3_F's stride-1 3x3 convolutions (models/clair3_fa.py, the three
// BasicBlocks' conv1 and conv2) for Hopper (sm_90a): the forward, the input
// gradient (dgrad) and the weight gradient (wgrad) as implicit GEMMs on
// wgmma fed by TMA (wgmma_product.cuh's persistent producer / consumer
// kernel), float32 operands as three bf16 pieces.
//
// It replaces no TPU kernel: the JAX package leaves its convolutions to
// XLA. It was added because cuDNN runs these float32 convolutions (TF32
// off) on the CUDA cores, as FFTs and implicit GEMMs, and they took most of
// the float32 Clair3_F train step on the card (PERF.md, Findings).
//
// What bounds it: at batch 2,000 the six convolutions' three products are
// 2.26 TFLOP a step, 13.6 TFLOP of bf16 products in six passes: 13.7 ms at
// the dense bf16 peak, against 8.7 GB of float32 activations and gradients
// read and written (2.6 ms at 3.35 TB/s). The products bound it, and their
// operands come from L2 once a tap: the design keeps enough stages in flight
// that the loads hide behind the products (measured: at two stages they did
// not), and walks output tiles in an order that keeps neighbouring blocks on
// the same rows of the input.
//
// Layouts. Activations stay NCHW float32 at the boundary. A split pass
// writes an activation's pieces as (B*H*W, 3, C) bf16, a cell's three
// pieces of its C channels side by side (clair_conv3x3_split); the weights
// (HWIO float32, (3, 3, Cin, Cout)) split into the forward's B operand
// (Cout, 3, 9*Cin) and the input gradient's (Cin, 3, 9*Cout), whose taps are
// rotated by 180 degrees (clair_conv3x3_weights).
//
// Forward and dgrad (ConvProblem): out[b, n, h, w] = sum over taps
// (dy, dx) and channels c of A[b, h + dy - 1, w + dx - 1, c] * Wt[n, tap, c]
// (+ bias[n]), M = B*H*W, N = the output channels, K = 9 * C. For stride 1
// the input gradient is the same product of the output gradient's pieces
// with the rotated, transposed kernel. An output tile is 128 cells: whole
// image rows (hb rows of W) or whole images (nb of H*W), whichever fits,
// read as one 5-D TMA box (channels, W, hb, nb) of one piece at
// (c, piece, dx - 1, h0 + dy - 1, b0): the SAME zero padding is the
// box's reach past the tensor's edges, which TMA fills with zeros. Rows of
// the box past its cells compute outputs that are not stored. A stage is one
// tap and 32 or 64 channels: A's three pieces and B's three pieces of the
// tile's N output channels (128 or 64).
//
// Wgrad (WgradProblem): dW[tap, ci, co] = sum over cells m of
// x[m shifted by the tap, ci] * g[m, co], a reduction over B*H*W (1.53M
// cells at the first stage). Computed as g^T . x: a consumer warpgroup's
// tile is 64 output channels x two 64-channel boxes of shifted x (128
// columns), both operands with rows along the reduction (MN-major), 32
// cells a stage by 3-D TMA boxes over the flat cells; x's box for tap
// (dy, dx) starts (dy - 1) * W + dx - 1 cells away, and a fix-up warp
// zeroes its rows whose shifted cell lies across the image's edge. The
// reduction is split into slabs of whole stages; each slab's partial sums
// land in their own buffer and a second pass sums the slabs in a fixed
// order, so two runs give the same bits (no atomics). The bias gradient is
// summed beside the products by side warps from the staged output gradient
// (each cell's pieces added first, then the cell, as mma_product.cuh's kDb,
// then each stage's 32 cells).
//
// Numerics (mma_product.cuh): every operand is float32 as three bf16
// pieces, p0 = bf16(v), p1 = bf16(v - p0), p2 = bf16(v - p0 - p1); the six
// piece pairs with i + j < 3 run as wgmma with float32 sums, no TF32; the
// pair (0, 0) sums in its own float32 accumulator, folded every 128 of the
// reduction into a third on the CUDA cores (PairAcc), and the five smaller
// pairs in another, added once per tile.
#include "mma_product.cuh"
#include "wgmma_product.cuh"

namespace {

constexpr int kTapCount = 9;
constexpr int kChunk = 64;                           // channels a 128-byte box row
constexpr int kWgradRows = 32;                       // cells a wgrad stage
constexpr int kWBoxBytes = kWgradRows * kRowBytes;   // 32 cells x 64 channels, 4 KB

// ---- the split passes ------------------------------------------------------

// NCHW float32 (batch, c, hw) -> (batch * hw, 3, c) bf16 pieces: a block
// takes 32 cells x 64 channels of one image through shared memory, reading
// along the cells and writing along the channels.
__global__ void split_activation(const float* __restrict__ src, bf16* __restrict__ dst, int c,
                                 int hw) {
    __shared__ float tile[kChunk][33];
    const int b = blockIdx.z, c0 = blockIdx.y * kChunk, p0 = blockIdx.x * 32;
    const float* in = src + (static_cast<size_t>(b) * c + c0) * hw;
    for (int i = threadIdx.x; i < kChunk * 32; i += blockDim.x) {
        const int ch = i >> 5, p = i & 31;
        tile[ch][p] = p0 + p < hw ? in[static_cast<size_t>(ch) * hw + p0 + p] : 0.0f;
    }
    __syncthreads();
    for (int i = threadIdx.x; i < 32 * (kChunk / 2); i += blockDim.x) {
        const int p = i >> 5, ch = (i & 31) * 2;
        if (p0 + p >= hw) break;
        const size_t cell = static_cast<size_t>(b) * hw + p0 + p;
        float rest[2] = {tile[ch][p], tile[ch + 1][p]};
        __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(dst + cell * kPieces * c + c0 + ch);
#pragma unroll
        for (int q = 0; q < kPieces; ++q) {
            const bf16 lo = __float2bfloat16_rn(rest[0]), hi = __float2bfloat16_rn(rest[1]);
            out[q * c / 2] = __halves2bfloat162(lo, hi);
            rest[0] -= __bfloat162float(lo);
            rest[1] -= __bfloat162float(hi);
        }
    }
}

// HWIO float32 (9, cin, cout) -> the forward's B operand (cout, 3, 9 * cin)
// and the input gradient's (cin, 3, 9 * cout), tap t there holding the
// kernel's tap 8 - t.
__global__ void split_weights(const float* __restrict__ w, bf16* __restrict__ w_fwd,
                              bf16* __restrict__ w_bwd, int cin, int cout) {
    const int n = kTapCount * cin * cout;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n; i += gridDim.x * blockDim.x) {
        const int co = i % cout, ci = (i / cout) % cin, tap = i / (cout * cin);
        float rest = w[i];
#pragma unroll
        for (int q = 0; q < kPieces; ++q) {
            const bf16 piece = __float2bfloat16_rn(rest);
            w_fwd[(static_cast<size_t>(co) * kPieces + q) * kTapCount * cin + tap * cin + ci] = piece;
            w_bwd[(static_cast<size_t>(ci) * kPieces + q) * kTapCount * cout +
                  (kTapCount - 1 - tap) * cout + co] = piece;
            rest -= __bfloat162float(piece);
        }
    }
}

// ---- wgmma at the widths these products take ------------------------------

// d (64 x N, float32) = A (64 x 16) . B (16 x N) + d where add, else
// without d; bf16 from shared memory (wgmma_product.cuh's wgmma_n192, at
// N = 64 and 128).
template <int TA, int TB>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t a, uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(add), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b, int add) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(add), "n"(TA), "n"(TB));
}

template <int N, int TA, int TB>
__device__ __forceinline__ void wgmma_at(float (&d)[N / 2], uint64_t a, uint64_t b, int add) {
    static_assert(N == 64 || N == 128, "no wrapper for this width");
    if constexpr (N == 64) wgmma_n64<TA, TB>(d, a, b, add);
    else wgmma_n128<TA, TB>(d, a, b, add);
}

// The accumulators of a consumer thread's m64nN tile ("Numerics"): the pair
// (0, 0)'s sums over at most kFoldDepth of the reduction in `hi`, folded
// into `total` on the CUDA cores, and the five smaller pairs' in `lo`. The
// tensor cores add each 16-deep step into their float32 sum by truncating
// what lies below its last bit, an error that grows with the depth: with
// one accumulator for the pair (0, 0) the forward at K = 2,304 read 2.5e-6
// of the largest element from float64 on an H100, near the 3.5e-6 that
// three piece pairs leave. Folds every 256 of the reduction keep those sums
// short and add them with float32's rounding to nearest (2.9e-7 there; a
// fold every 128 read 2.2e-7 and took 3% longer, every 64 2.5e-7 and 10%
// longer). `lo` is 2^-8 of the sum, so its truncations stay below
// float32's last bit.
constexpr int kFoldDepth = 256;

template <int N>
struct PairAcc {
    float hi[N / 2];
    float lo[N / 2];
    float total[N / 2];
    int stages;  // stages of the reduction in hi
    __device__ __forceinline__ void zero() {
        zero_acc(hi);
        zero_acc(lo);
        zero_acc(total);
        stages = 0;
    }
    __device__ __forceinline__ void fence() {
        fence_acc(hi);
        fence_acc(lo);
        fence_acc(total);
    }
    // At a stage's start, before its products: after kFold stages, wait for
    // the products in flight and fold hi into total. Returns 0 where the
    // stage's first (0, 0) product is to overwrite hi, else 1.
    template <int kFold>
    __device__ __forceinline__ int begin_stage() {
        if (stages < kFold) {
            ++stages;
            return 1;
        }
        wgmma_wait<0>();
        fence_acc(hi);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) total[i] += hi[i];
        fence_acc(total);
        wgmma_fence();  // hi was read: the next wgmma follows the reads
        stages = 1;
        return 0;
    }
    // The sum of element i, once the products are done.
    __device__ __forceinline__ float value(int i) const { return (total[i] + hi[i]) + lo[i]; }
};

// The six piece pairs of one 16-deep step: a(i) and b(j) give piece i's and
// j's descriptors; the pair (0, 0) adds to hi where add, else overwrites it.
template <int N, int TA, int TB, class DescA, class DescB>
__device__ __forceinline__ void six_passes(PairAcc<N>& acc, DescA a, DescB b, int add) {
#pragma unroll
    for (int i = 0; i < kPieces; ++i)
#pragma unroll
        for (int j = 0; j + i < kPieces; ++j) {
            if (i + j == 0) wgmma_at<N, TA, TB>(acc.hi, a(i), b(j), add);
            else wgmma_at<N, TA, TB>(acc.lo, a(i), b(j), 1);
        }
}

// One box of a rank-5 map at coordinates c (innermost first), its bytes
// completing on `bar`.
__device__ __forceinline__ void tma_load5(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                          int c1, int c2, int c3, int c4) {
    asm volatile(
        "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
        "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
        "r"(c3), "r"(c4)
        : "memory");
}

// A K-major tile of kK-channel rows at reduction step kk (16 deep, 32
// bytes along the rows): 64 channels in the 128-byte swizzle
// (wgmma_product.cuh's k_major_at), 32 in the 64-byte one (rows of 64
// bytes, 8-row atoms of 512 bytes, the sbo; layout type 2).
template <int kK>
__device__ __forceinline__ uint64_t k_major_rows_at(uint32_t addr, int kk) {
    static_assert(kK == 32 || kK == 64, "rows of 64 or 128 bytes");
    if constexpr (kK == 64) {
        return k_major_at(addr, kk);
    } else {
        const uint32_t a = addr + kk * 32;
        return static_cast<uint64_t>((a & 0x3FFFF) >> 4) | (1ull << 16) |
               (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
    }
}

// ---- forward and dgrad -----------------------------------------------------

// out (batch, n_total, H, W) float32 = the implicit GEMM of A's pieces
// (batch * H * W, 3, c_red) and B's (n_total, 3, 9 * c_red), plus bias
// where given. Tiles: (m tile, n tile), n fastest; m tile = (image group
// g, row chunk q) covering images g * nb .. + nb - 1 and rows q * hb ..
// + hb - 1. A [cell][c] and B [n][c], both K-major, kK channels a stage:
// at N = 128, 32 channels in the 64-byte swizzle, so that a stage of 48 KB
// leaves room for four in flight (64 channels fit two, and the loads and
// the products then ran one after the other); at N = 64, 64 channels in the
// 128-byte swizzle, three stages of 72 KB (32 channels ran slower there).
template <int kN, int kK>
struct ConvProblem {
    static constexpr int kRow = 2 * kK;                  // bytes of a box row
    static constexpr int kABoxBytes = kWgBM * kRow;      // 128 cells of one piece
    static constexpr int kBBytes = kN * kRow;            // one piece of B
    static constexpr int kStageBytes = kPieces * (kABoxBytes + kBBytes);
    static constexpr int kStages = (kWgSmemLimit - 2048) / kStageBytes;
    static constexpr int kExtraBytes = 0;
    static constexpr bool kFix = false;
    static constexpr int kSideWarps = 0;
    using Acc = PairAcc<kN>;
    CUtensorMap a_map;  // (c_red, 3, W, H, batch), box kK x 1 x W x hb x nb
    CUtensorMap b_map;  // (9 * c_red, 3, n_total), box kK x 1 x kN
    const float* bias;  // or null
    float* out;
    int batch, height, width, c_red, n_total, hb, nb, h_chunks, m_tiles, n_tiles, chunks;
    unsigned a_box_bytes;  // width * hb * nb cells of one piece, at most kABoxBytes

    __host__ __device__ int tiles() const { return m_tiles * n_tiles; }
    __device__ int k_steps(int) const { return kTapCount * chunks; }
    __device__ unsigned stage_bytes(int) const { return kPieces * (a_box_bytes + kBBytes); }
    __device__ void origin(int tile, int& b0, int& h0, int& n0) const {
        const int mt = tile / n_tiles;
        n0 = (tile - mt * n_tiles) * kN;
        b0 = (mt / h_chunks) * nb;
        h0 = (mt % h_chunks) * hb;
    }
    // k = tap * chunks + chunk
    __device__ void load(int tile, int k, unsigned char* s, uint64_t* bar) const {
        int b0, h0, n0;
        origin(tile, b0, h0, n0);
        const int tap = k / chunks, c0 = (k - tap * chunks) * kK;
        const int dy = tap / 3 - 1, dx = tap % 3 - 1;
#pragma unroll
        for (int q = 0; q < kPieces; ++q) {
            tma_load5(s + q * kABoxBytes, &a_map, bar, c0, q, dx, h0 + dy, b0);
            tma_load(s + kPieces * kABoxBytes + q * kBBytes, &b_map, bar, tap * c_red + c0, q, n0);
        }
    }
    __device__ void fix(int, int, unsigned char*, int) const {}
    __device__ void mma(Acc& acc, const unsigned char* stage, int half, int) const {
        const uint32_t a = smem_u32(stage) + half * kWgRows * kRow;
        const uint32_t b = smem_u32(stage) + kPieces * kABoxBytes;
        const int add = acc.template begin_stage<kFoldDepth / kK>();
#pragma unroll
        for (int kk = 0; kk < kK / 16; ++kk)
            six_passes<kN, 0, 0>(acc, [&](int i) { return k_major_rows_at<kK>(a + i * kABoxBytes, kk); },
                                 [&](int j) { return k_major_rows_at<kK>(b + j * kBBytes, kk); },
                                 kk == 0 ? add : 1);
    }
    // Each thread's rows r0 and r0 + 8 of the warpgroup's 64, as (image,
    // row, column) of the box; the fragment's columns are output channels.
    __device__ void store(int tile, int half, const Acc& acc, unsigned char*) const {
        int b0, h0, n0;
        origin(tile, b0, h0, n0);
        const int t = threadIdx.x & 127, l = t & 31;
        const int box_cells = hb * width, hw = height * width;
#pragma unroll
        for (int h2 = 0; h2 < 2; ++h2) {
            const int r = half * kWgRows + (t >> 5) * 16 + (l >> 2) + 8 * h2;
            if (r >= box_cells * nb) continue;
            const int bb = r / box_cells, rem = r - bb * box_cells;
            const int hh = rem / width, b = b0 + bb, h = h0 + hh;
            if (b >= batch || h >= height) continue;
            float* o = out + static_cast<size_t>(b) * n_total * hw + h * width + (rem - hh * width);
#pragma unroll
            for (int j = 0; j < kN / 8; ++j) {
                const int n = n0 + 8 * j + 2 * (l & 3);
                float v0 = acc.value(4 * j + 2 * h2);
                float v1 = acc.value(4 * j + 2 * h2 + 1);
                if (bias != nullptr) {
                    v0 += bias[n];
                    v1 += bias[n + 1];
                }
                o[static_cast<size_t>(n) * hw] = v0;
                o[static_cast<size_t>(n + 1) * hw] = v1;
            }
        }
    }
};

// ---- wgrad -----------------------------------------------------------------

// partial[slab][n][co] (n = tap * cin + ci) = the slab's sum over cells m
// of x[m + shift(tap)][ci] * g[m][co], and partial_db[slab][co] its sum of
// g. kAB output-channel boxes a stage: 2 where cout is a multiple of 128
// (each consumer warpgroup its own 64 channels, both the same two x boxes),
// else 1 (both warpgroups the same 64 channels, each its own two of four x
// boxes). The x boxes are the (tap, 64 input channels) units u =
// tap * (cin / 64) + chunk, kBB a stage. Stage: g's boxes [a][piece], then
// x's [piece][box], 4 KB each. Tiles: (slab, co group, n group), n group
// fastest.
template <int kAB>
struct WgradProblem {
    static constexpr int kBB = 4 / kAB;
    static constexpr int kGBytes = kAB * kPieces * kWBoxBytes;
    static constexpr int kStageBytes = (kAB + kBB) * kPieces * kWBoxBytes;
    static constexpr int kStages = (kWgSmemLimit - 2048) / kStageBytes;
    static constexpr int kExtraBytes = 0;
    static constexpr bool kFix = true;
    static constexpr int kSideWarps = kAB;  // the bias gradient of each g box
    using Acc = PairAcc<128>;
    struct Side {
        float db[2];  // this lane's two output channels
    };
    CUtensorMap g_map;  // (cout, 3, cells), box 64 x 1 x 32
    CUtensorMap x_map;  // (cin, 3, cells), box 64 x 1 x 32
    float* partial;     // (slabs, 9 * cin * cout + cout)
    int cells, height, width, cin, cout, units, slabs, slab_rows, co_groups, n_groups;

    __host__ __device__ int tiles() const { return slabs * co_groups * n_groups; }
    __device__ void at(int tile, int& slab, int& cg, int& ng) const {
        ng = tile % n_groups;
        cg = (tile / n_groups) % co_groups;
        slab = tile / (n_groups * co_groups);
    }
    __device__ int valid_boxes(int ng) const { return min(kBB, units - ng * kBB); }
    __device__ int k_steps(int tile) const {
        int slab, cg, ng;
        at(tile, slab, cg, ng);
        const int m0 = slab * slab_rows, m1 = min(cells, m0 + slab_rows);
        return (m1 - m0 + kWgradRows - 1) / kWgradRows;
    }
    __device__ unsigned stage_bytes(int tile) const {
        return (kAB + valid_boxes(tile % n_groups)) * kPieces * kWBoxBytes;
    }
    __device__ int shift(int u) const {
        const int tap = u / (cin / kChunk);
        return (tap / 3 - 1) * width + tap % 3 - 1;
    }
    __device__ void load(int tile, int k, unsigned char* s, uint64_t* bar) const {
        int slab, cg, ng;
        at(tile, slab, cg, ng);
        const int m0 = slab * slab_rows + k * kWgradRows, boxes = valid_boxes(ng);
#pragma unroll
        for (int q = 0; q < kPieces; ++q) {
#pragma unroll
            for (int a = 0; a < kAB; ++a)
                tma_load(s + (a * kPieces + q) * kWBoxBytes, &g_map, bar, (cg * kAB + a) * kChunk, q,
                         m0);
            for (int j = 0; j < boxes; ++j) {
                const int u = ng * kBB + j;
                tma_load(s + kGBytes + (q * kBB + j) * kWBoxBytes, &x_map, bar,
                         (u % (cin / kChunk)) * kChunk, q, m0 + shift(u));
            }
        }
    }
    // Row `lane` of the stage: zero each x box's row whose shifted cell
    // lies across the image's edge (rows past the cells meet zeros of g).
    __device__ void fix(int tile, int k, unsigned char* s, int lane) const {
        int slab, cg, ng;
        at(tile, slab, cg, ng);
        const int m = slab * slab_rows + k * kWgradRows + lane;
        if (m >= cells) return;
        const int w = m % width, h = (m / width) % height, boxes = valid_boxes(ng);
        for (int j = 0; j < boxes; ++j) {
            const int tap = (ng * kBB + j) / (cin / kChunk);
            const int y = h + tap / 3 - 1, x = w + tap % 3 - 1;
            if (y < 0 || y >= height || x < 0 || x >= width) {
#pragma unroll
                for (int q = 0; q < kPieces; ++q)
                    zero_row(s + kGBytes + (q * kBB + j) * kWBoxBytes, lane);
            }
        }
    }
    // This warpgroup's g box and its first x box.
    __device__ void boxes_of(int half, int& a, int& j0) const {
        a = kAB == 2 ? half : 0;
        j0 = kAB == 2 ? 0 : 2 * half;
    }
    __device__ void mma(Acc& acc, const unsigned char* stage, int half, int) const {
        int a, j0;
        boxes_of(half, a, j0);
        // (a warpgroup whose boxes lie past the units multiplies what its
        // stage holds, and its store skips them: a branch around wgmma here
        // would serialize every wgmma of the kernel)
        const uint32_t g = smem_u32(stage) + a * kPieces * kWBoxBytes;
        const uint32_t x = smem_u32(stage) + kGBytes + j0 * kWBoxBytes;
        const int add = acc.template begin_stage<kFoldDepth / kWgradRows>();
#pragma unroll
        for (int kk = 0; kk < kWgradRows / 16; ++kk)
            six_passes<128, 1, 1>(
                acc, [&](int i) { return wgmma_desc(g + i * kWBoxBytes + kk * 16 * kRowBytes, kWBoxBytes, 1024); },
                [&](int j) {
                    return wgmma_desc(x + j * kBB * kWBoxBytes + kk * 16 * kRowBytes, kWBoxBytes, 1024);
                },
                kk == 0 ? add : 1);
    }
    // db of channels 2 lane, 2 lane + 1 of g box `warp`, in the tiles of n
    // group 0: the stage's 32 cells in order (cells past the tensor are
    // zeros), each cell's pieces added first, then the stage's sum: a sum
    // of a slab's ~11,600 cells one by one loses 1.5e-6 to 2.2e-6 of the
    // largest element at batch 2,000, by stages 3.6e-7 to 5.0e-7
    __device__ void side(Side& st, int tile, const unsigned char* stage, int warp, int lane) const {
        if (tile % n_groups != 0) return;
        const uint32_t p = smem_u32(stage) + warp * kPieces * kWBoxBytes + (lane & 3) * 4;
        float s0 = 0.0f, s1 = 0.0f;
#pragma unroll 4
        for (int r = 0; r < kWgradRows; ++r) {
            const uint32_t at = r * kRowBytes + (((lane >> 2) ^ (r & 7)) << 4);
            float v0 = 0.0f, v1 = 0.0f;
#pragma unroll
            for (int q = 0; q < kPieces; ++q) {
                const float2 v = bf16x2_float2(ld_shared_b32(p + q * kWBoxBytes + at));
                v0 += v.x;
                v1 += v.y;
            }
            s0 += v0;
            s1 += v1;
        }
        st.db[0] += s0;
        st.db[1] += s1;
    }
    __device__ void side_store(const Side& st, int tile, int warp, int lane) const {
        int slab, cg, ng;
        at(tile, slab, cg, ng);
        if (ng != 0) return;
        const size_t per_slab = static_cast<size_t>(kTapCount) * cin * cout + cout;
        float* db = partial + slab * per_slab + kTapCount * cin * cout;
        const int co = (cg * kAB + warp) * kChunk + 2 * lane;
        *reinterpret_cast<float2*>(db + co) = make_float2(st.db[0], st.db[1]);
    }
    // Rows are output channels, columns the warpgroup's two x boxes.
    __device__ void store(int tile, int half, const Acc& acc, unsigned char*) const {
        int slab, cg, ng, a, j0;
        at(tile, slab, cg, ng);
        boxes_of(half, a, j0);
        const int u0 = ng * kBB + j0;
        if (u0 >= units) return;
        const int t = threadIdx.x & 127, l = t & 31;
        const int co = (cg * kAB + a) * kChunk + (t >> 5) * 16 + (l >> 2);
        const size_t per_slab = static_cast<size_t>(kTapCount) * cin * cout + cout;
        float* out = partial + slab * per_slab;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
            const int c = 8 * j + 2 * (l & 3);
            if (u0 + c / kChunk >= units) continue;
            const size_t n = static_cast<size_t>(u0) * kChunk + c;
#pragma unroll
            for (int h2 = 0; h2 < 2; ++h2) {
                out[n * cout + co + 8 * h2] = acc.value(4 * j + 2 * h2);
                out[(n + 1) * cout + co + 8 * h2] = acc.value(4 * j + 2 * h2 + 1);
            }
        }
    }
};

// dw (9 * cin * cout, HWIO) and db (cout) = the slabs' partial sums, added
// in slab order.
__global__ void sum_slabs(const float* __restrict__ partial, float* __restrict__ dw,
                          float* __restrict__ db, int slabs, int n_w, int cout) {
    const int per_slab = n_w + cout;
    for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < per_slab; i += gridDim.x * blockDim.x) {
        float s = 0.0f;
        for (int k = 0; k < slabs; ++k) s += partial[static_cast<size_t>(k) * per_slab + i];
        if (i < n_w) dw[i] = s;
        else db[i - n_w] = s;
    }
}

// ---- host ------------------------------------------------------------------

// A bf16 tensor map of rank R whose boxes' rows are kK channels, in the
// swizzle of their width (wgmma_product.cuh's tensor_map takes the 128-byte
// one alone): zeros past the edges.
template <int kK, int R>
cudaError_t bf16_map_rows(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[R],
                          const cuuint64_t (&strides)[R - 1], const cuuint32_t (&box)[R]) {
    const EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return cudaErrorSharedObjectSymbolNotFound;
    cuuint32_t unit[R];
    for (int i = 0; i < R; ++i) unit[i] = 1;
    const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, R, const_cast<void*>(base), dims,
                              strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                              kK == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                              CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                              CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// The pieces of an activation, (cells, 3, c): rank 5 over (c, 3, W, H,
// batch) with boxes (kK, 1, W, hb, nb), or rank 3 over (c, 3, cells) with
// boxes of 64 channels x kWgradRows cells.
template <int kK>
cudaError_t cells_map5(CUtensorMap* map, const void* pieces, int batch, int c, int height, int width,
                       int hb, int nb) {
    const cuuint64_t row = 2ull * kPieces * c;
    const cuuint64_t dims[5] = {static_cast<cuuint64_t>(c), kPieces, static_cast<cuuint64_t>(width),
                                static_cast<cuuint64_t>(height), static_cast<cuuint64_t>(batch)};
    const cuuint64_t strides[4] = {2ull * c, row, row * width, row * width * height};
    const cuuint32_t box[5] = {kK, 1, static_cast<cuuint32_t>(width), static_cast<cuuint32_t>(hb),
                               static_cast<cuuint32_t>(nb)};
    return bf16_map_rows<kK>(map, pieces, dims, strides, box);
}
cudaError_t cells_map3(CUtensorMap* map, const void* pieces, long long cells, int c) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(c), kPieces, static_cast<cuuint64_t>(cells)};
    const cuuint64_t strides[2] = {2ull * c, 2ull * kPieces * c};
    const cuuint32_t box[3] = {kChunk, 1, kWgradRows};
    return bf16_map(map, pieces, dims, strides, box);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

template <int kN, int kK>
cudaError_t launch_conv(const void* a_pieces, const void* b_pieces, const float* bias, float* out,
                        int batch, int c_red, int n_total, int height, int width, cudaStream_t stream) {
    ConvProblem<kN, kK> p{};
    // a tile: whole images where one fits in 128 cells, else whole rows
    const int hw = height * width;
    p.nb = hw <= kWgBM ? kWgBM / hw : 1;
    p.hb = hw <= kWgBM ? height : kWgBM / width;
    p.a_box_bytes = static_cast<unsigned>(ConvProblem<kN, kK>::kRow * width * p.hb * p.nb);
    cudaError_t err = cells_map5<kK>(&p.a_map, a_pieces, batch, c_red, height, width, p.hb, p.nb);
    if (err == cudaSuccess) {
        const cuuint64_t dims[3] = {static_cast<cuuint64_t>(kTapCount) * c_red, kPieces,
                                    static_cast<cuuint64_t>(n_total)};
        const cuuint64_t strides[2] = {2ull * kTapCount * c_red, 2ull * kPieces * kTapCount * c_red};
        const cuuint32_t box[3] = {kK, 1, kN};
        err = bf16_map_rows<kK>(&p.b_map, b_pieces, dims, strides, box);
    }
    if (err != cudaSuccess) return err;
    p.bias = bias;
    p.out = out;
    p.batch = batch;
    p.height = height;
    p.width = width;
    p.c_red = c_red;
    p.n_total = n_total;
    p.h_chunks = ceil_div(height, p.hb);
    p.m_tiles = ceil_div(batch, p.nb) * p.h_chunks;
    p.n_tiles = n_total / kN;
    p.chunks = c_red / kK;
    return launch_wgmma(p, p.tiles(), stream);
}

template <int kAB>
cudaError_t launch_wgrad(const void* x_pieces, const void* g_pieces, float* partial, int batch,
                         int cin, int cout, int height, int width, int slabs, int slab_rows,
                         cudaStream_t stream) {
    WgradProblem<kAB> p{};
    const long long cells = static_cast<long long>(batch) * height * width;
    cudaError_t err = cells_map3(&p.g_map, g_pieces, cells, cout);
    if (err == cudaSuccess) err = cells_map3(&p.x_map, x_pieces, cells, cin);
    if (err != cudaSuccess) return err;
    p.partial = partial;
    p.cells = static_cast<int>(cells);
    p.height = height;
    p.width = width;
    p.cin = cin;
    p.cout = cout;
    p.units = kTapCount * cin / kChunk;
    p.slabs = slabs;
    p.slab_rows = slab_rows;
    p.co_groups = cout / (kAB * kChunk);
    p.n_groups = ceil_div(p.units, WgradProblem<kAB>::kBB);
    return launch_wgmma(p, p.tiles(), stream);
}

// Shapes every entry takes; the wrapper (ops/conv3x3.py) checks them first.
bool fits(int batch, int cin, int cout, int height, int width) {
    const long long cells = static_cast<long long>(batch) * height * width;
    return batch > 0 && height > 0 && width > 0 && width <= kWgBM && cin % kChunk == 0 &&
           cout % kChunk == 0 && cin > 0 && cout > 0 && cells < (1ll << 31) - 2 * kWgBM;
}

}  // namespace

// src NCHW float32 (batch, c, hw) -> dst (batch * hw, 3, c) bf16 pieces.
extern "C" int clair_conv3x3_split(const void* src, void* dst, int batch, int c, int hw,
                                   void* stream) {
    if (batch <= 0 || hw <= 0 || c % kChunk != 0 || batch > 65535) return cudaErrorInvalidValue;
    const dim3 grid(ceil_div(hw, 32), c / kChunk, batch);
    split_activation<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(src), static_cast<bf16*>(dst), c, hw);
    return cudaGetLastError();
}

// w HWIO float32 (3, 3, cin, cout) -> w_fwd (cout, 3, 9 * cin), w_bwd
// (cin, 3, 9 * cout), bf16 pieces.
extern "C" int clair_conv3x3_weights(const void* w, void* w_fwd, void* w_bwd, int cin, int cout,
                                     void* stream) {
    if (cin % kChunk != 0 || cout % kChunk != 0 || cin <= 0 || cout <= 0) return cudaErrorInvalidValue;
    const int n = kTapCount * cin * cout;
    split_weights<<<ceil_div(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(w), static_cast<bf16*>(w_fwd), static_cast<bf16*>(w_bwd), cin, cout);
    return cudaGetLastError();
}

// out NCHW float32 (batch, n_total, H, W) = the stride-1 3x3 convolution of
// a's pieces (batch * H * W, 3, c_red) with b's (n_total, 3, 9 * c_red),
// SAME zero padding, plus bias (n_total, or null). The forward takes x's
// pieces and w_fwd (n_total = cout); the input gradient the output
// gradient's pieces and w_bwd (n_total = cin, no bias).
extern "C" int clair_conv3x3_product(const void* a_pieces, const void* b_pieces, const void* bias,
                                     void* out, int batch, int c_red, int n_total, int height,
                                     int width, void* stream) {
    if (!fits(batch, c_red, n_total, height, width)) return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* b = static_cast<const float*>(bias);
    float* o = static_cast<float*>(out);
    return n_total % 128 == 0
        ? launch_conv<128, 32>(a_pieces, b_pieces, b, o, batch, c_red, n_total, height, width, s)
        : launch_conv<64, 64>(a_pieces, b_pieces, b, o, batch, c_red, n_total, height, width, s);
}

// dw HWIO float32 (3, 3, cin, cout) and db (cout) from x's pieces and the
// output gradient's (batch * H * W, 3, c): the slabs' partial sums into
// `partial` (slabs, 9 * cin * cout + cout), then their sum in slab order.
// Every slab but the last holds slab_rows cells, a multiple of 32.
extern "C" int clair_conv3x3_wgrad(const void* x_pieces, const void* g_pieces, void* partial,
                                   void* dw, void* db, int batch, int cin, int cout, int height,
                                   int width, int slabs, int slab_rows, void* stream) {
    if (!fits(batch, cin, cout, height, width) || slabs <= 0 || slab_rows % kWgradRows != 0 ||
        static_cast<long long>(slabs) * slab_rows < static_cast<long long>(batch) * height * width)
        return cudaErrorInvalidValue;
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    float* part = static_cast<float*>(partial);
    cudaError_t err = cout % 128 == 0
        ? launch_wgrad<2>(x_pieces, g_pieces, part, batch, cin, cout, height, width, slabs, slab_rows, s)
        : launch_wgrad<1>(x_pieces, g_pieces, part, batch, cin, cout, height, width, slabs, slab_rows, s);
    if (err != cudaSuccess) return err;
    const int n_w = kTapCount * cin * cout;
    const int blocks = ceil_div(n_w + cout, kThreads);
    sum_slabs<<<blocks, kThreads, 0, s>>>(part, static_cast<float*>(dw), static_cast<float*>(db), slabs,
                                          n_w, cout);
    return cudaGetLastError();
}
