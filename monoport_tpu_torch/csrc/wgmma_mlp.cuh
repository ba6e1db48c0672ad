// Shared device code of the bf16 wgmma MLP kernels for Hopper (sm_90a):
// fused_mlp.cu (the per-point MLP, kernel 2) and fused_ray_mlp.cu (the ray
// MLP, kernel 1, and the anchored ray MLP, kernel 3) include this file, each
// instantiates wgmma_mlp_kernel with its layer epilogue, and each adds its
// plain C entry points. The gathering ray MLP (kernel 4) launches kernel 1's
// instantiation on the rows its weighted-row pass makes (mix_rows.cuh).
//
// A row of either kernel is one input row x [c_in] bf16 and one output row
// [out_dim] f32; layer i computes
//     acc_i = [h_{i-1} | x] . [W_h[i]; W_x[i]] + term_i(row, col),
//     acc_0 = x W_x[0] + term_0(row, col)
// (f(cat[h, x]) = W_h h + W_x x + ...), leaky-ReLU 0.01 between layers,
// sigmoid / tanh / none after the last; sums and the epilogue term are f32
// and h is rounded after each activation. The epilogue is the only
// difference between the kernels:
//  * PointEpilogue (kernel 2): term = b[col]; x is the whole input row, z
//    included, and a block owns 64 points.
//  * RayEpilogue (kernel 1): term = b[col] + z[r, t] * w_z[col] in f32; x is
//    the ray's feature row, shared by its T taps, and a block owns 64 rays
//    at one tap. The shared projection x . W_x is recomputed for every tap.
//  * AnchorEpilogue (kernel 3): RayEpilogue's arithmetic at one tap; x is
//    the tap's mixed anchor row (mix_rows.cuh), and a block owns 64 (ray,
//    tap) rows. Its own name tells kernel 3 from kernel 1 in a profile.
//
// The design: one pass, one launch, no scratch, as the TPU kernels keep x
// and h in VMEM. A block runs every layer as one K loop over [h_{i-1} | x]
// on wgmma m64nNk16 (bf16 operands from shared memory, f32 sums in
// registers):
//  * two consumer warpgroups split a layer's N columns (N/2 <= 256 each, at
//    most 128 accumulators a thread); layers wider than 512 run in passes
//    of 512 (only the first and the last, which do not write the h they
//    read). Layer widths round up to 32, 64, 128, 256 or a multiple of 512
//    (zero weights) so that every layer is one instruction width.
//  * one shared h buffer [64, <= 1024] bf16 (128 KB): a hidden layer holds
//    its whole output in registers until both warpgroups have read the
//    last of its input, then overwrites h in place, in the layout the next
//    layer's wgmma reads (8 x 8 core matrices, no swizzle).
//  * one producer thread feeds a 2-stage ring through full / empty
//    mbarriers. A stage is 32 of K: the weights' [N, 32] tile, pre-tiled at
//    pack time into wgmma's core-matrix layout and loaded with one
//    cp.async.bulk (no tensor map), and, in the skip part of the K loop,
//    the block's [64, 32] x tile through a TMA tensor map (64-byte swizzle;
//    rows past the end arrive as zeros). x does not stay resident: 64 x 288
//    (netG) or 64 x 544 (netC) bf16 does not fit beside h and the ring, so
//    it streams again each layer (~9% of the bytes).
//  * shared memory: 131,072 B h + 2 x (32,768 + 4,096) B ring + 1 KB of
//    alignment = 205,856 B of the 232,448 a block may use: one block an SM.
//    A 5-stage ring of 16-deep stages keeping one wgmma group in flight
//    was slower on an H100 (2.09 against 1.66 ms at 262,144 points): twice
//    the barrier round trips for the same bytes.
//  * the hidden-layer epilogue is a few instructions an element (no
//    branch, no transcendental): with the general activation inline it took
//    ~3 of 3.8 ms at 262,144 points on an H100, more than the wgmma it
//    follows. Its per-column terms come in one vector load a column pair
//    (float2 of b; float4 of {b, b, w_z, w_z} for the ray), its per-row z
//    in registers, read once a block.
// Bound: operations on paper, but every 64-row block streams all the packed
// weights from L2 (2.5 MB for netG): L2 bandwidth is the floor of this
// tiling. The stream entry points run the same ring with no math and
// measure it (PERF.md). Halving it needs BM = 128 or 2-block clusters with
// multicast weight tiles.

#pragma once

// CUtensorMap; the CUDA driver API's encoder is fetched at run time
#include <cuda.h>
#include <cuda_bf16.h>

#include "mlp_tiles.cuh"

namespace {

constexpr int kBM = 64;                  // rows a block
constexpr int kBK = 32;                  // K depth of a ring stage
constexpr int kPassN = 512;              // columns a pass (2 x n256)
constexpr int kStages = 2;
constexpr int kConsumerThreads = 256;    // two warpgroups
constexpr int kWgmmaThreads = kConsumerThreads + 32;   // + the producer warp
constexpr int kWTileBytes = kPassN * kBK * 2;
constexpr int kXTileBytes = kBM * kBK * 2;
constexpr int kStageBytes = kWTileBytes + kXTileBytes;
constexpr int kMaxHidden = 1024;         // h buffer width
// core-matrix layout of a [64, K] operand (h, the x tile): element (r, k)
// at (k / 8) * kRowBlock + (r / 8) * 128 + (r % 8) * 16 + (k % 8) * 2 bytes
constexpr int kRowBlock = kBM * 16;

struct WgmmaDims {
  int n_layers, c_in, out_dim, last_op;
  int width[kMaxLayers];                 // kernel widths of the layers
};

// Kernel 2's epilogue: acc + b[col]. Block b owns points [64 b, 64 b + 64).
struct PointEpilogue {
  const float* bias;                     // [sum(widths)] f32, kernel widths
  float* out;                            // [n_rows, out_dim] f32
  int n_rows;

  __device__ __forceinline__ int begin(int block) { return block * kBM; }
  __device__ __forceinline__ void load_rows(int, int) {}
  // columns col, col + 1 (col even, counted over every layer) of a row in
  // the thread's upper (hi = 0) or lower (hi = 1) group of 8
  __device__ __forceinline__ float2 add(int col, float a0, float a1,
                                        int) const {
    const float2 bv = __ldg(reinterpret_cast<const float2*>(bias + col));
    return make_float2(a0 + bv.x, a1 + bv.y);
  }
  __device__ __forceinline__ float* row_out(int r, int out_dim) const {
    return out + (size_t)r * out_dim;
  }
};

// Kernel 1's epilogue: acc + b[col] + z[r, t] * w_z[col], in f32 as the
// plain version adds it. Block b owns rays [64 (b / T), + 64) at tap b % T:
// the T blocks that read one feature tile run next to each other and find
// it in L2.
struct RayEpilogue {
  const float4* bwz;                     // column pair c / 2: {b[c], b[c + 1],
                                         // w_z[c], w_z[c + 1]}, kernel widths
  const float* z;                        // [n_rows, taps] f32
  float* out;                            // [n_rows, taps, out_dim] f32
  int n_rows, taps;
  int tap;
  float z0, z1;                          // z of the thread's two rows

  __device__ __forceinline__ int begin(int block) {
    tap = block % taps;
    return block / taps * kBM;
  }
  __device__ __forceinline__ void load_rows(int row0, int row) {
    const int r = row0 + row;
    z0 = r < n_rows ? __ldg(z + (size_t)r * taps + tap) : 0.f;
    z1 = r + 8 < n_rows ? __ldg(z + (size_t)(r + 8) * taps + tap) : 0.f;
  }
  __device__ __forceinline__ float2 add(int col, float a0, float a1,
                                        int hi) const {
    const float4 q = __ldg(bwz + (col >> 1));
    const float zr = hi ? z1 : z0;
    return make_float2(a0 + fmaf(zr, q.z, q.x), a1 + fmaf(zr, q.w, q.y));
  }
  __device__ __forceinline__ float* row_out(int r, int out_dim) const {
    return out + ((size_t)r * taps + tap) * out_dim;
  }
};

// Kernel 3's epilogue: RayEpilogue at taps = 1 over R * T (ray, tap) rows,
// each a mixed anchor row: acc + b[col] + z[row] * w_z[col] in f32. Block b
// owns rows [64 b, 64 b + 64).
struct AnchorEpilogue : RayEpilogue {
  __device__ __forceinline__ int begin(int block) {
    tap = 0;
    return block * kBM;
  }
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(count));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes) : "memory");
}

// Wait for the phase of the given parity to complete. A phase that never
// completes (a protocol fault) traps after ~2 s instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_addr(bar);
  const long long start = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(a), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - start > (1ll << 32)) __trap();
  }
}

// bytes from device memory to shared memory, counted on bar's transactions
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)), "l"(src), "r"(bytes),
      "r"(smem_addr(bar)) : "memory");
}

// a [64, 32] tile of x [n_rows, c_in] at (row0, k0) by the tensor map; rows
// past the end arrive as zeros
__device__ __forceinline__ void tma_load_x(void* dst, const CUtensorMap* map,
                                           int k0, int row0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(k0), "r"(row0),
      "r"(smem_addr(bar)) : "memory");
}

// wgmma shared-memory descriptors, K-major. No swizzle: lbo = bytes between
// the two core matrices along K, sbo = bytes between 8-row groups. 64-byte
// swizzle (the x tile as the tensor map writes it): 64-byte rows, 512-byte
// groups of 8 rows, the second 16 of K 32 bytes on.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32);
}
__device__ __forceinline__ uint64_t smem_desc_sw64(uint32_t addr) {
  return smem_desc(addr, 16, 512) | (2ull << 62);
}

__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// keep the compiler from moving accumulator reads across wgmma's
// asynchronous writes
template <int R>
__device__ __forceinline__ void pin(float* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}


// D[64, N] (+)= A[64, 16] . B[N, 16]^T, both K-major in shared memory
template <int N>
struct Mma;

template <>
struct Mma<16> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, %8, %9, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<32> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15"
        "}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<64> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<128> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63"
        "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};

template <>
struct Mma<256> {
  static __device__ __forceinline__ void run(float* d, uint64_t a, uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
        "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
        "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
        "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "
        "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, "
        "%84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
        "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, "
        "%108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
        "%120, %121, %122, %123, %124, %125, %126, %127"
        "}, %128, %129, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
          "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
          "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
          "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
          "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
          "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
          "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
          "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
          "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
          "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
          "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
          "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
          "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
          "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
          "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
          "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
          "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
          "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
          "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
          "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
          "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
          "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
          "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
        : "l"(a), "l"(b), "r"(scale_d));
  }
};


// The producer (one thread starts every copy): each ring stage of the
// block's layer loop, in the consumers' order. A stage is the next
// [N_pass, 32] weight tile of the packed stream (one bulk copy) and, in the
// skip part of a K loop, the block's [64, 32] x tile (one tensor-map copy).
__device__ __forceinline__ void produce(const WgmmaDims& d, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty,
                                        const CUtensorMap* xmap,
                                        const unsigned char* __restrict__ w,
                                        int row0) {
  int it = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int n = d.width[l], pn = n < kPassN ? n : kPassN;
    const uint32_t wbytes = pn * kBK * 2;
    const int nh = l ? d.width[l - 1] / kBK : 0, nk = nh + d.c_in / kBK;
    for (int p = 0; p < n / pn; ++p) {
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % kStages;
        mbar_wait(&empty[s], ((it / kStages) & 1) ^ 1);
        unsigned char* stage = ring + s * kStageBytes;
        const bool with_x = kt >= nh;
        mbar_expect_tx(&full[s], wbytes + (with_x ? kXTileBytes : 0));
        bulk_load(stage, w, wbytes, &full[s]);
        if (with_x)
          tma_load_x(stage + kWTileBytes, xmap, (kt - nh) * kBK, row0,
                     &full[s]);
        w += wbytes;
      }
    }
  }
}

// Layer l, all its passes, for the calling consumer warpgroup, which owns
// NW of each pass's columns. boff is the layer's first column over every
// layer; it counts the ring stages consumed.
template <int NW, bool Math, class Epi>
__device__ __forceinline__ void consume_layer(
    int l, const WgmmaDims& d, unsigned char* ring, uint64_t* full,
    uint64_t* empty, unsigned char* h, const Epi& epi, int boff, int row0,
    int& it) {
  const int wg = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int warp = t >> 5, lane = t & 31;
  const int n = d.width[l], pn = n < kPassN ? n : kPassN;
  const int nh = l ? d.width[l - 1] / kBK : 0, nk = nh + d.c_in / kBK;
  const bool last = l == d.n_layers - 1;
  for (int p = 0; p < n / pn; ++p) {
    float acc[NW / 2];
#pragma unroll
    for (int j = 0; j < NW / 2; ++j) acc[j] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % kStages;
      // (with the math off one thread a warpgroup waits and releases: no
      // wgmma holds its warps together)
      if (Math || t == 0) mbar_wait(&full[s], (it / kStages) & 1);
      if constexpr (Math) {
        // A: the h columns [32 kt, 32 kt + 32), or the stage's x tile
        unsigned char* stage = ring + s * kStageBytes;
        const bool from_h = kt < nh;
        const uint32_t a = from_h ? smem_addr(h) + kt * (kBK / 8) * kRowBlock
                                  : smem_addr(stage + kWTileBytes);
        const uint32_t b = smem_addr(stage) + wg * (NW / 8) * 128;
        pin<NW / 2>(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk)
          Mma<NW>::run(acc,
                       from_h ? smem_desc(a + kk * 2 * kRowBlock, kRowBlock, 128)
                              : smem_desc_sw64(a + kk * 32),
                       smem_desc(b + kk * 2 * pn * 16, pn * 16, 128), 1);
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        pin<NW / 2>(acc);
      }
      if (t == 0) mbar_arrive(&empty[s]);
    }
    if constexpr (Math) {
      // a hidden layer past the first overwrites the h it reads: wait
      // until both warpgroups are done with it
      if (l > 0 && !last) consumers_sync();
      // accumulator j of this thread: row 16 warp + lane / 4 + 8 (j / 2 % 2),
      // column p pn + wg NW + 8 (j / 4) + 2 (lane % 4) + j % 2. The loops are
      // unrolled over up to 128 accumulators: the hidden epilogue is kept to
      // a few instructions an element.
      const int row = warp * 16 + (lane >> 2);
      const int col = p * pn + wg * NW + (lane & 3) * 2;
      if (!last) {
        unsigned char* hp = h + (col >> 3) * kRowBlock + (row >> 3) * 128 +
                            (row & 7) * 16 + (col & 7) * 2;
#pragma unroll
        for (int j = 0; j < NW / 2; j += 2) {
          const float2 v = epi.add(boff + col + (j >> 2) * 8, acc[j],
                                   acc[j + 1], (j >> 1) & 1);
          // leaky-ReLU 0.01: max(v, 0.01 v)
          *reinterpret_cast<__nv_bfloat162*>(hp + (j >> 2) * kRowBlock +
                                             ((j >> 1) & 1) * 128) =
              __floats2bfloat162_rn(fmaxf(v.x, 0.01f * v.x),
                                    fmaxf(v.y, 0.01f * v.y));
        }
      } else {
#pragma unroll
        for (int j = 0; j < NW / 2; j += 2) {
          const int r = row0 + row + 8 * ((j >> 1) & 1);
          const int c = col + (j >> 2) * 8;
          if (r < epi.n_rows && c < d.out_dim) {
            const float2 v = epi.add(boff + c, acc[j], acc[j + 1],
                                     (j >> 1) & 1);
            float* o = epi.row_out(r, d.out_dim) + c;
            o[0] = activate(v.x, true, d.last_op);
            if (c + 1 < d.out_dim) o[1] = activate(v.y, true, d.last_op);
          }
        }
      }
    }
  }
  if (Math && !last) {
    // h was written by generic stores and is read next by wgmma (the
    // async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    consumers_sync();
  }
}

// x [n_rows, c_in] bf16 through xmap; w the packed weight stream; epi the
// layer epilogue and the output. Math = false runs the ring alone (every
// load, no wgmma, no output): the stream's floor.
template <class Epi, bool Math>
__global__ void __launch_bounds__(kWgmmaThreads, 1)
    wgmma_mlp_kernel(const __grid_constant__ CUtensorMap xmap,
                     const unsigned char* __restrict__ w, const Epi epi_arg,
                     WgmmaDims d) {
  extern __shared__ __align__(128) unsigned char wgmma_smem[];
  // the ring first, at a 1024-byte boundary: the x tiles' 64-byte swizzle
  // repeats every 512 bytes
  unsigned char* ring = wgmma_smem + ((1024 - (smem_addr(wgmma_smem) & 1023))
                                      & 1023);
  unsigned char* h = ring + kStages * kStageBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(h + kBM * kMaxHidden * 2);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);            // the producer's expect_tx
      mbar_init(&empty[s], 2);           // one arrival a consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  Epi epi = epi_arg;
  const int row0 = epi.begin(blockIdx.x);
  if (threadIdx.x >= kConsumerThreads) {
    if (threadIdx.x == kConsumerThreads)
      produce(d, ring, full, empty, &xmap, w, row0);
    return;
  }
  if constexpr (Math)
    epi.load_rows(row0, (threadIdx.x & 127) / 32 * 16 +
                            (threadIdx.x & 31) / 4);
  int it = 0, boff = 0;
  for (int l = 0; l < d.n_layers; ++l) {
    const int nw = (d.width[l] < kPassN ? d.width[l] : kPassN) / 2;
#define MLP_LAYER(NW)                                                       \
  case NW:                                                                  \
    consume_layer<NW, Math>(l, d, ring, full, empty, h, epi, boff, row0,    \
                            it);                                            \
    break;
    switch (nw) {
      MLP_LAYER(16)
      MLP_LAYER(32)
      MLP_LAYER(64)
      MLP_LAYER(128)
      MLP_LAYER(256)
    }
#undef MLP_LAYER
    boff += d.width[l];
  }
}

constexpr size_t kWgmmaSmem =
    1024 + (size_t)kStages * kStageBytes + kBM * kMaxHidden * 2 +
    2 * kStages * sizeof(uint64_t);

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// The tensor map of x [n_rows, c_in] bf16 in [64, 32] boxes, 64-byte
// swizzle. cuTensorMapEncodeTiled comes from the CUDA driver API through
// the runtime, so the library needs no -lcuda.
inline int encode_x_map(CUtensorMap* map, const void* x, int n_rows,
                        int c_in) {
  static EncodeTiled encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                              cudaEnableDefault, &found);
    if (err != cudaSuccess) return (int)err;
    if (found != cudaDriverEntryPointSuccess || fn == nullptr) return 1012;
    encode = reinterpret_cast<EncodeTiled>(fn);
  }
  const cuuint64_t dims[2] = {(cuuint64_t)c_in, (cuuint64_t)n_rows};
  const cuuint64_t strides[1] = {(cuuint64_t)c_in * 2};
  const cuuint32_t box[2] = {kBK, kBM};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(x), dims,
      strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_64B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : 2000 + (int)r;
}

// Check the kernel widths of the layers and fill d: 0, or 1000 + code for a
// bad argument.
inline int wgmma_dims(WgmmaDims* d, const int* widths, int n_layers, int c_in,
                      int out_dim, int last_op) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 1001;
  if (out_dim < 1) return 1002;
  if (c_in < kBK || c_in % kBK) return 1003;
  *d = WgmmaDims{};
  d->n_layers = n_layers;
  d->c_in = c_in;
  d->out_dim = out_dim;
  d->last_op = last_op;
  for (int i = 0; i < n_layers; ++i) {
    const int v = widths[i];
    const bool one_pass = v == 32 || v == 64 || v == 128 || v == 256 ||
                          v == kPassN;
    if (!one_pass && (v < kPassN || v % kPassN)) return 1003;
    // h holds a hidden layer's output; one written in place takes one pass
    if (i < n_layers - 1 && v > kMaxHidden) return 1011;
    if (i > 0 && i < n_layers - 1 && !one_pass) return 1011;
    d->width[i] = v;
  }
  if (out_dim > d->width[n_layers - 1]) return 1004;
  return 0;
}

// Launch `blocks` blocks over x [n_rows, d.c_in] bf16 on the stream.
template <class Epi, bool Math>
int wgmma_launch(const void* x, int n_rows, const void* w, const Epi& epi,
                 long long blocks, const WgmmaDims& d, void* stream) {
  if (n_rows < 1 || blocks < 1 || blocks > 0x7fffffffll) return 1002;
  CUtensorMap xmap;
  const int bad = encode_x_map(&xmap, x, n_rows, d.c_in);
  if (bad) return bad;
  cudaError_t err = cudaFuncSetAttribute(
      wgmma_mlp_kernel<Epi, Math>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)kWgmmaSmem);
  if (err != cudaSuccess) return (int)err;
  wgmma_mlp_kernel<Epi, Math><<<(unsigned)blocks, kWgmmaThreads, kWgmmaSmem,
                                static_cast<cudaStream_t>(stream)>>>(
      xmap, static_cast<const unsigned char*>(w), epi, d);
  return (int)cudaGetLastError();
}

}  // namespace
