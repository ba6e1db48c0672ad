// Shared device code of the f32 routes of the fused skip-concat MLP kernels
// for Hopper (sm_90a): fused_ray_mlp.cu (ray and anchored ray MLP),
// fused_mlp.cu (per-point MLP) and fused_gather_mlp.cu (ray MLP with the
// bilinear feature gather inside) include this file and add their plain C
// entry points. These are the parity routes: wgmma has no f32 operands, and
// TF32 would break the 2e-5 parity with the f32 reference. Every bf16 route
// runs wgmma_mlp.cuh (and mix_rows.cuh) instead.
//
// One function covers the three forms. A "ray" r carries n_anchors input
// rows feat[r, k] (C wide) and T taps; layer i computes, for tap t,
//     acc_i = sum_k w[r, t, k] * xp_i[r, k] + z[r, t] * w_z[i] + b[i]
//             (+ h_{i-1} . W_h[i], i > 0)
// where xp_i[r, k] = feat[r, k] . W_f[i] is shared by all T taps of the ray;
// leaky-ReLU 0.01 between layers, sigmoid / tanh / none after the last.
//  * ray MLP:       n_anchors = 1, no weights (w = 1);
//  * anchored MLP:  n_anchors = K, w = the per-tap hat weights (f32);
//  * per-point MLP: n_anchors = 1, T = 1, no z term (z is a column of feat);
//  * gathering ray MLP: the ray MLP whose input row is not read but made in
//    shared memory from four rows of a [H*W, C] table (gather_xproj_kernel).
// Operands and sums are f32, on plain FMA: every output is one fmaf chain
// over k in ascending order from 0, then the epilogue.
//
// Bound on the card: operations, at the 67 TFLOP/s of f32 outside the
// tensor cores (128 FMA lanes an SM a clock). A block GEMM on FMA reaches it
// only if the lanes are fed: every FFMA needs its two operands in
// registers, and shared memory gives an SM 128 B a clock.
//
// Design:
//  * xproj_kernel computes xp = feat . [W_f0 | ... | W_f(L-1)] once per
//    input row into an f32 scratch [rows, N_tot] in device memory. A TPU
//    core keeps these projections in VMEM; here they would not fit next to
//    the activations in 227 KB of shared memory, so they take one round
//    trip through device memory.
//  * mlp_kernel: a block owns BM = 32 flattened (ray, tap) rows and runs all
//    layers with the activations ping-ponging between two shared-memory
//    buffers; the epilogue adds the row's (mixed) shared projection, the
//    rank-1 z term and the bias, activates, and writes the next layer's
//    input (or the output).
//  * the block GEMM (gemm_pass) computes BM rows x a pass of NT columns,
//    NT = 512, 256, 128 or 32, taken greedily from the layer's N (a
//    1,952-column xp is 512 x 3 + 256 + 128 + 32): one algorithm whose tile
//    follows the shape. Eight FMA warps each own NT / 8 columns of every
//    row; a thread owns TR rows (interleaved, 32 / TR apart; the row is the
//    fastest lane index) x TG groups of 4 contiguous columns: 8 x 8 at NT 512, 8 x 4 at 256, 4 x 4 at 128,
//    1 x 4 at 32. Per 4 k a thread loads TR activation float4s and 4 TG
//    weight float4s: 16 FFMAs a 16-byte shared load at NT 512, 10.7 at 256,
//    8 at 128.
//  * operands and activations are stored k4-major (quad()): element (m, k)
//    at ((k / 4) * BM + m) * 4 + k % 4. A thread's row loads are fixed
//    offsets from one base register (rows of a runtime stride put a chain
//    of address arithmetic before each stage's loads: 4-9% slower on an
//    H100), a warp's loads of one k-quad are contiguous (no padding, no
//    bank conflict), and the epilogue's float4 of 4 contiguous columns is
//    one quad of the next layer's input.
//  * the weight ring: W_f and each W_h are kept a second time at pack time
//    in the order the loop reads them (ops/cuda/fused_ray_mlp.py:
//    f32_tiles): a pass's [K, NT] block, k-major, contiguous, so a stage of
//    BK = min(2048 / NT, 32) k-rows is one cp.async.bulk of 8 KB (4 KB at
//    NT 32) with no transposing stores. A ninth warp's elected thread walks
//    the same passes as the FMA warps and keeps 4 stages in flight, each
//    completed on its full mbarrier; a warp waits on a stage's barrier and
//    frees it with one arrival on its empty barrier: no __syncthreads a
//    K-tile, and the next layer's first stages arrive during an epilogue.
//    The same thread prefetches into L2 the xp rows each layer's epilogue
//    will read (cp.async.bulk.prefetch), a layer ahead: 2-4% on an H100.
//  * measured on an H100 (PERF.md): the ring alone streams 2.6-2.8x faster
//    than the kernel computes, and the FMA loop alone (no ring) is only
//    ~1.2x faster than the whole: the loop, not the weights' latency, is
//    the limit, at ~43-46% of the FMA peak (8 warps, two a scheduler). The
//    ninth warp puts three warps on one scheduler's 16K registers, so ptxas
//    caps the block at 168 a thread: loading the next quad's activations
//    a step ahead spills there and was slower.
//  * the epilogue: a thread's columns are contiguous, so xp, w_z and b come
//    as float4s (the expression act(acc + sp + z * w_z + b) as before); a
//    branch per row keeps its loads from being hoisted over the whole tile
//    (a branch-free form spilled).
//  * shared memory of mlp_kernel: the ring 4 x 8,192 B + its 8 barriers,
//    the activations BM x (widest even layer + widest odd layer) x 4 B (32 x
//    (1,024 + 512) x 4 = 196,608 B for the published 1024-512 heads) and
//    the row terms (z, the ray, <= 8 anchor weights a row): 230,720 B of
//    the 232,448 a block may opt into for netG / netC: one block an SM.
//    xproj_kernel: the ring and its BM input rows (65,600 B at C = 256).
//  * the scratch is bounded: the launcher walks the rays in chunks that fit
//    the scratch it is given (whole waves of blocks where they fit), each
//    chunk an xproj launch and an mlp launch on the same stream, so the
//    scratch does not grow with the ray count.
//  * channel widths are padded to multiples of 32 by the packer; T and
//    n_anchors are runtime arguments.
//  * activation scratch, for heads whose two activation buffers pass the
//    232,448 B a block may opt into beside the ring (32 x (2,048 + 1,024) x
//    4 = 393,216 B for a 2048-1024 head). The packer decides from the
//    widths, before any launch (ops/cuda/fused_ray_mlp.py: f32_scratch),
//    and passes a device-memory scratch of h_slots blocks' buffers: the
//    layer kernel then keeps h_a / h_b there (k4-major too), runs a
//    persistent grid of at most h_slots blocks, each block its own slot,
//    walking the row blocks, and its shared memory holds only the ring and
//    the row terms. The same FMA code reads and writes them, so the
//    arithmetic (and the 2e-5 parity) is unchanged.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxAnchors = 8;
constexpr int kThreads = 256;                 // the FMA warps
constexpr int kFmaWarps = kThreads / 32;
constexpr int kTileThreads = kThreads + 32;   // + the producer warp
constexpr int kTileBM = 32;                   // rows a block
constexpr int kRingStages = 4;
constexpr int kStageFloats = 2048;            // 8 KB a stage at most
constexpr int kRingBytes =
    kRingStages * kStageFloats * 4 + 2 * kRingStages * 8;   // + barriers

// A block's rows of an operand or activation [BM, K] in shared (or device)
// memory are stored k4-major: element (m, k) at ((k / 4) * BM + m) * 4 +
// k % 4. Four k of a row are one float4, the rows of a k-quad are
// contiguous, so a thread's row loads sit at fixed offsets from one base,
// and a warp's 16-byte loads and the epilogue's float4 stores of one
// k-quad hit distinct banks. The float4 of (m, k..k + 3), k % 4 = 0:
__host__ __device__ __forceinline__ int quad(int m, int k) {
  return k * kTileBM + 4 * m;
}

struct MlpDims {
  int n_layers;
  int width[kMaxLayers + 1];     // padded: [C_f, out_0, ..., out_(L-1)]
  int xoff[kMaxLayers];          // column of layer i in xp / w_z / b
  long long whoff[kMaxLayers];   // element offset of layer i >= 1's tiles
  int ntot;                      // sum of padded layer widths
  int out_dim;
  int last_op;                   // 0 none, 1 sigmoid, 2 tanh
};

__device__ __forceinline__ float activate(float x, bool last, int last_op) {
  if (!last) return x > 0.f ? x : x * 0.01f;
  if (last_op == 1) return 1.f / (1.f + expf(-x));
  if (last_op == 2) return tanhf(x);
  return x;
}

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

// bytes of device memory into L2, no completion to wait for
__device__ __forceinline__ void prefetch_l2(const void* src, uint32_t bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;\n" ::"l"(src),
               "r"(bytes) : "memory");
}

// the kThreads FMA threads of a block (its first warps), not its producer
// warp
__device__ __forceinline__ void fma_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// A pass's width: the widest of 512, 256, 128, 32 that the columns left
// hold (they are a multiple of 32). The packer cuts the weights by the same
// rule (ops/cuda/fused_ray_mlp.py: f32_passes).
__host__ __device__ __forceinline__ int pass_width(int left) {
  return left >= 512 ? 512 : left >= 256 ? 256 : left >= 128 ? 128 : 32;
}

// The thread tile of a pass NT columns wide: TR rows x TG float4 column
// groups a thread; WC column lanes x WR row lanes a warp; BK k-rows a stage.
template <int NT>
struct Tile {
  static constexpr int TG = NT == 512 ? 2 : 1;
  static constexpr int WC = NT / (kFmaWarps * 4 * TG);
  static constexpr int WR = 32 / WC;
  static constexpr int TR = kTileBM / WR;
  static constexpr int BK = kStageFloats / NT < 32 ? kStageFloats / NT : 32;
  static_assert(WC * WR == 32 && TR * WR == kTileBM, "tile");
};

__device__ __forceinline__ int stage_depth(int nt) {
  return nt == 512 ? Tile<512>::BK : nt == 256 ? Tile<256>::BK
       : nt == 128 ? Tile<128>::BK : Tile<32>::BK;
}

// The ring's state in a block: its stages and their full / empty barriers,
// and the position of the next stage (counted over the block's life, the
// same on the producer's and the consumers' side).
struct Ring {
  float* stages;
  uint64_t* full;
  uint64_t* empty;
  unsigned it;
};

// Lay out the ring at the start of the dynamic shared memory and init its
// barriers (thread 0); every thread of the block must call it. Returns the
// first byte after it.
__device__ __forceinline__ unsigned char* ring_init(unsigned char* smem,
                                                    Ring& ring) {
  ring.stages = reinterpret_cast<float*>(smem);
  ring.full = reinterpret_cast<uint64_t*>(smem + kRingStages * kStageFloats *
                                                     4);
  ring.empty = ring.full + kRingStages;
  ring.it = 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kRingStages; ++s) {
      mbar_init(&ring.full[s], 1);           // the producer's expect_tx
      mbar_init(&ring.empty[s], kFmaWarps);  // one arrival an FMA warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  return smem + kRingBytes;
}

// The producer: every stage of the passes of an N-column product over K,
// w its tile stream ([K, NT] k-major a pass, passes in column order).
__device__ __forceinline__ void produce_passes(Ring& ring, const float* w,
                                               int K, int N) {
  for (int n0 = 0; n0 < N;) {
    const int nt = pass_width(N - n0), bk = stage_depth(nt);
    const uint32_t bytes = (uint32_t)bk * nt * 4;
    const float* src = w + (size_t)n0 * K;
    for (int k0 = 0; k0 < K; k0 += bk, ++ring.it) {
      const unsigned s = ring.it % kRingStages;
      mbar_wait(&ring.empty[s], ((ring.it / kRingStages) & 1) ^ 1);
      mbar_expect_tx(&ring.full[s], bytes);
      bulk_load(ring.stages + s * kStageFloats, src + (size_t)k0 * nt, bytes,
                &ring.full[s]);
    }
    n0 += nt;
  }
}

// One pass of the block GEMM: columns [n0, n0 + NT) of A[BM, K] (k4-major,
// quad(), in shared or device memory) . W, W's pass streamed through the ring.
// Every output is one fmaf chain over k from 0; epi(m, col, v) gets row m's
// four contiguous columns col..col + 3.
template <int NT, class Epi>
__device__ __forceinline__ void gemm_pass(const float* A, int K,
                                          Ring& ring, int n0, Epi& epi) {
  using Tl = Tile<NT>;
  constexpr int TR = Tl::TR, TG = Tl::TG, GAP = NT / TG;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // rows fastest over the lanes: the 8 lanes of a 16-byte access phase
  // then store at most 2 k-quads of the k4-major output (<= 2-way bank
  // conflict; the 8 quads of one row would be 8-way)
  const int rl = lane % Tl::WR;
  const int c0 = 4 * (warp * Tl::WC + lane / Tl::WR);
  const float* arow = A + quad(rl, 0);
  float acc[TR][TG][4];
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int g = 0; g < TG; ++g)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][g][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += Tl::BK, ++ring.it) {
    const unsigned s = ring.it % kRingStages;
    mbar_wait(&ring.full[s], (ring.it / kRingStages) & 1);
    const float* sb = ring.stages + s * kStageFloats + c0;
#pragma unroll
    for (int kk = 0; kk < Tl::BK; kk += 4) {
      float a[TR][4];
#pragma unroll
      for (int r = 0; r < TR; ++r) {
        const float4 v = *reinterpret_cast<const float4*>(
            arow + (size_t)(k0 + kk) * kTileBM + quad(r * Tl::WR, 0));
        a[r][0] = v.x;
        a[r][1] = v.y;
        a[r][2] = v.z;
        a[r][3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float b[TG][4];
#pragma unroll
        for (int g = 0; g < TG; ++g) {
          const float4 v =
              *reinterpret_cast<const float4*>(sb + (kk + q) * NT + g * GAP);
          b[g][0] = v.x;
          b[g][1] = v.y;
          b[g][2] = v.z;
          b[g][3] = v.w;
        }
#pragma unroll
        for (int r = 0; r < TR; ++r)
#pragma unroll
          for (int g = 0; g < TG; ++g)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              acc[r][g][j] = fmaf(a[r][q], b[g][j], acc[r][g][j]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&ring.empty[s]);
  }
#pragma unroll
  for (int r = 0; r < TR; ++r)
#pragma unroll
    for (int g = 0; g < TG; ++g)
      epi(rl + r * Tl::WR, n0 + c0 + g * GAP, acc[r][g]);
}

// The pass [n0, n0 + nt) by its width's tile.
template <class Epi>
__device__ __forceinline__ void gemm_pass_at(const float* A, int K,
                                             Ring& ring, int n0, int nt,
                                             Epi& epi) {
  if (nt == 512)
    gemm_pass<512>(A, K, ring, n0, epi);
  else if (nt == 256)
    gemm_pass<256>(A, K, ring, n0, epi);
  else if (nt == 128)
    gemm_pass<128>(A, K, ring, n0, epi);
  else
    gemm_pass<32>(A, K, ring, n0, epi);
}

// The consumers' side of produce_passes: every pass of an N-column product.
template <class Epi>
__device__ __forceinline__ void gemm(const float* A, int K, int N,
                                     Ring& ring, Epi epi) {
  for (int n0 = 0; n0 < N; n0 += pass_width(N - n0))
    gemm_pass_at(A, K, ring, n0, pass_width(N - n0), epi);
}

// The row m and k-quad kv that thread-item q of a block's [BM, K] rows
// copies: 8 neighbouring items are 8 quads of one row (128 contiguous bytes
// of a row-major source), a warp's 32 four rows.
__device__ __forceinline__ void quad_of(int q, int& m, int& kv) {
  m = (q >> 3) % kTileBM;
  kv = (q >> 3) / kTileBM * 8 + (q & 7);
}

// Load rows [r0, r0 + BM) of a row-major [n_rows, K] f32 matrix into shared
// memory, k4-major (rows past n_rows are zero). The FMA warps, 8 loads in
// flight a thread: the block runs alone on its SM, so nothing else hides
// their latency.
__device__ void load_rows(float* dst, const float* src, int r0, int n_rows,
                          int K) {
  constexpr int U = 8;
  const int n = kTileBM * (K / 4);
  for (int q0 = threadIdx.x; q0 < n; q0 += U * kThreads) {
    float4 v[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int m, kv;
      quad_of(q0 + u * kThreads, m, kv);
      v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + u * kThreads < n && r0 + m < n_rows)
        v[u] = *reinterpret_cast<const float4*>(src + (size_t)(r0 + m) * K +
                                                kv * 4);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      int m, kv;
      quad_of(q0 + u * kThreads, m, kv);
      if (q0 + u * kThreads < n)
        *reinterpret_cast<float4*>(dst + quad(m, kv * 4)) = v[u];
    }
  }
}

// Make BM input rows in shared memory (k4-major) by bilinear gather:
// row m = sum_k wgt[m, k] * table[idx[m, k]] over its four taps, table
// row-major [*, K] f32. A thread makes one 16-byte vector of a row from four
// 16-byte loads (quad_of: a warp reads 128 contiguous bytes of each of four
// rows of each tap); products
// and sums are f32, rounded one by one and added in tap order, which is the
// plain version's arithmetic bit for bit (no fused multiply-add). s_idx,
// s_wgt: the block's [BM, 4] indices and weights in shared memory; a tap
// outside the image carries a clipped index and weight 0, as do rows past
// the end. The FMA warps.
__device__ void gather_rows(float* dst, const float* __restrict__ table,
                            const int* s_idx, const float* s_wgt, int K) {
  for (int q = threadIdx.x; q < kTileBM * (K / 4); q += kThreads) {
    int m, kv;
    quad_of(q, m, kv);
    float acc[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float4 f = *reinterpret_cast<const float4*>(
          table + (size_t)s_idx[m * 4 + k] * K + kv * 4);
      const float w = s_wgt[m * 4 + k];
      const float p[4] = {__fmul_rn(f.x, w), __fmul_rn(f.y, w),
                          __fmul_rn(f.z, w), __fmul_rn(f.w, w)};
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[j] = k == 0 ? p[j] : __fadd_rn(acc[j], p[j]);
    }
    *reinterpret_cast<float4*>(dst + quad(m, kv * 4)) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
}

__device__ __forceinline__ void load4(float* v, const float* p) {
  const float4 t = *reinterpret_cast<const float4*>(p);
  v[0] = t.x;
  v[1] = t.y;
  v[2] = t.z;
  v[3] = t.w;
}

// The shared projection of row m at 4 neighbouring columns from col: xp of
// the ray's single input row, or (Mixed) the hat-weighted sum over its
// n_anchors rows (s_w: the block's [BM, n_anchors] weights).
template <bool Mixed>
__device__ __forceinline__ void shared_proj(float* sp,
                                            const float* __restrict__ xp,
                                            const float* s_w, int m, int ray,
                                            int n_anchors, int ntot, int col) {
  if constexpr (Mixed) {
    const float* p = xp + (size_t)ray * n_anchors * ntot + col;
#pragma unroll
    for (int j = 0; j < 4; ++j) sp[j] = 0.f;
    for (int k = 0; k < n_anchors; ++k) {
      float t[4];
      load4(t, p + (size_t)k * ntot);
      const float wgt = s_w[m * n_anchors + k];
#pragma unroll
      for (int j = 0; j < 4; ++j) sp[j] = fmaf(wgt, t[j], sp[j]);
    }
  } else {
    load4(sp, xp + (size_t)ray * ntot + col);
  }
}

// The first column of pass `pass` of an n-column product, and its passes.
__host__ __device__ __forceinline__ int pass_start(int n, int pass) {
  int n0 = 0;
  for (int p = 0; p < pass; ++p) n0 += pass_width(n - n0);
  return n0;
}

__host__ __device__ __forceinline__ int n_passes(int n) {
  int count = 0;
  for (int n0 = 0; n0 < n; n0 += pass_width(n - n0)) ++count;
  return count;
}

// Every column of xp for the block's BM input rows in sA (rows r0..), one
// pass (pass >= 0) or all of them (pass < 0). The FMA warps.
__device__ __forceinline__ void xproj_columns(const float* sA, int c_f,
                                              Ring& ring,
                                              float* __restrict__ xp, int r0,
                                              int R, int ntot, int pass) {
  auto epi = [&](int m, int col, const float* v) {
    if (r0 + m < R)
      *reinterpret_cast<float4*>(xp + (size_t)(r0 + m) * ntot + col) =
          make_float4(v[0], v[1], v[2], v[3]);
  };
  if (pass < 0) {
    gemm(sA, c_f, ntot, ring, epi);
    return;
  }
  const int n0 = pass_start(ntot, pass);
  gemm_pass_at(sA, c_f, ring, n0, pass_width(ntot - n0), epi);
}

// xp[R, ntot] = feat[R, C_f] . W_f^T, W_f's tile stream wf. Block
// (pass, row block): the pass's columns of the block's BM rows.
__global__ void __launch_bounds__(kTileThreads, 1)
    xproj_kernel(const float* __restrict__ feat, const float* __restrict__ wf,
                 float* __restrict__ xp, int R, int c_f, int ntot) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  float* sA = reinterpret_cast<float*>(ring_init(smem, ring));
  const int pass = blockIdx.x, r0 = blockIdx.y * kTileBM;
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads) {
      const int n0 = pass_start(ntot, pass);
      produce_passes(ring, wf + (size_t)n0 * c_f, c_f, pass_width(ntot - n0));
    }
    return;
  }
  load_rows(sA, feat, r0, R, c_f);
  fma_sync();
  xproj_columns(sA, c_f, ring, xp, r0, R, ntot, pass);
}

// The same projection with the input rows gathered inside the kernel:
// row r = sum_k wgt[r, k] * table[idx[r, k]] (gather_rows), never written to
// device memory. The grid is the row blocks alone: a block gathers its BM
// rows once and walks every column pass itself.
__global__ void __launch_bounds__(kTileThreads, 1)
    gather_xproj_kernel(const float* __restrict__ table,
                        const int* __restrict__ idx,
                        const float* __restrict__ wgt,
                        const float* __restrict__ wf, float* __restrict__ xp,
                        int R, int c_f, int ntot) {
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  float* sA = reinterpret_cast<float*>(ring_init(smem, ring));
  int* s_idx = reinterpret_cast<int*>(sA + kTileBM * c_f);
  float* s_wgt = reinterpret_cast<float*>(s_idx + kTileBM * 4);
  const int r0 = blockIdx.x * kTileBM;
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads) produce_passes(ring, wf, c_f, ntot);
    return;
  }
  for (int q = threadIdx.x; q < kTileBM * 4; q += kThreads) {
    const bool live = r0 + q / 4 < R;
    s_idx[q] = live ? idx[(size_t)r0 * 4 + q] : 0;
    s_wgt[q] = live ? wgt[(size_t)r0 * 4 + q] : 0.f;
  }
  fma_sync();
  gather_rows(sA, table, s_idx, s_wgt, c_f);
  fma_sync();
  xproj_columns(sA, c_f, ring, xp, r0, R, ntot, -1);
}

// The mean of a point's views' shared projections at 4 neighbouring columns
// from col: xp rows point * views .. point * views + views - 1, summed in
// view order, then scaled by inv = 1 / views (a power of two: exact).
__device__ __forceinline__ void view_proj(float* sp,
                                          const float* __restrict__ xp,
                                          int point, int views, float inv,
                                          int ntot, int col) {
  const float* p = xp + (size_t)point * views * ntot + col;
  load4(sp, p);
  for (int v = 1; v < views; ++v) {
    float t[4];
    load4(t, p + (size_t)v * ntot);
#pragma unroll
    for (int j = 0; j < 4; ++j) sp[j] += t[j];
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) sp[j] *= inv;
}

// Pool a block's activations of width w (k4-major) over each group of views
// rows in place: every row of a group gets the group's mean (summed in view
// order, then scaled by inv). The FMA warps.
__device__ __forceinline__ void pool_views(float* h, int w, int views,
                                           float inv) {
  const int groups = kTileBM / views, w4 = w / 4;
  for (int q = threadIdx.x; q < groups * w4; q += kThreads) {
    const int m0 = (q % groups) * views, k = (q / groups) * 4;
    float s[4];
    load4(s, h + quad(m0, k));
    for (int v = 1; v < views; ++v) {
      float t[4];
      load4(t, h + quad(m0 + v, k));
#pragma unroll
      for (int j = 0; j < 4; ++j) s[j] += t[j];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] *= inv;
    for (int v = 0; v < views; ++v)
      *reinterpret_cast<float4*>(h + quad(m0 + v, k)) =
          make_float4(s[0], s[1], s[2], s[3]);
  }
}

// The per-(ray, tap) MLP over BM flattened rows (row = ray * taps + tap).
// z may be null (no z term). Mixed: wk holds the rows' hat weights over the
// ray's n_anchors input rows; else a ray has one input row of weight 1.
// wh: the tile streams of layers 1.. (d.whoff). Scratch false: the
// activations in shared memory, one row block a block; true: the block's
// slot of the device-memory activation scratch hs ([gridDim.x, BM, w_a +
// w_b]) and a walk over every row block, gridDim.x apart. w_a, w_b: the
// widest even- and odd-index layer, the two buffers' widths (k4-major).
// Pooled (the view-pooled form, per-point rows, taps 1): rows are `views`
// views of each point, point-major; after layer P = n_layers / 2 each
// group's activations are replaced by their mean (pool_views), layers
// after P take the mean of the group's projections (view_proj) as their
// skip term, and the last layer writes one output row a point.
template <bool Mixed, bool Scratch, bool Pooled>
__device__ __forceinline__ void mlp_rows(
    const float* __restrict__ xp, const float* __restrict__ z,
    const float* __restrict__ wk, const float* __restrict__ wh,
    const float* __restrict__ wz, const float* __restrict__ bias,
    float* __restrict__ out, int rows, int taps, int n_anchors, int w_a,
    int w_b, float* hs, const MlpDims& d, int views) {
  constexpr int BM = kTileBM;
  extern __shared__ __align__(128) unsigned char smem[];
  Ring ring;
  float* after = reinterpret_cast<float*>(ring_init(smem, ring));
  float* h_a = Scratch ? hs + (size_t)blockIdx.x * BM * (w_a + w_b) : after;
  float* h_b = h_a + BM * w_a;
  float* s_z = Scratch ? after : h_b + BM * w_b;
  int* s_ray = reinterpret_cast<int*>(s_z + BM);
  float* s_w = reinterpret_cast<float*>(s_ray + BM);

  const int n_blocks = (rows + BM - 1) / BM;
  const int stride = Scratch ? gridDim.x : n_blocks;
  const int L = d.n_layers;
  const int pool = Pooled ? L / 2 : L;
  const float inv = 1.f / views;
  if (threadIdx.x >= kThreads) {
    if (threadIdx.x == kThreads)
      for (int blk = blockIdx.x; blk < n_blocks; blk += stride) {
        // the xp rows the block's epilogues read, into L2 a layer ahead (a
        // row of the per-point form is its own ray)
        const int ray0 = blk * BM / taps;
        const int last = ((blk + 1) * BM < rows ? (blk + 1) * BM : rows) - 1;
        const int n_in = (last / taps - ray0 + 1) * n_anchors;
        const float* x0 = xp + (size_t)ray0 * n_anchors * d.ntot;
        for (int i = 0; i < L; ++i) {
          for (int r = 0; r < n_in; ++r)
            prefetch_l2(x0 + (size_t)r * d.ntot + d.xoff[i],
                        d.width[i + 1] * 4);
          if (i > 0)
            produce_passes(ring, wh + d.whoff[i], d.width[i], d.width[i + 1]);
        }
      }
    return;
  }

  for (int blk = blockIdx.x; blk < n_blocks; blk += stride) {
    const int row0 = blk * BM;
    for (int m = threadIdx.x; m < BM; m += kThreads) {
      const int gr = row0 + m;
      s_z[m] = (z != nullptr && gr < rows) ? z[gr] : 0.f;
      s_ray[m] = gr < rows ? gr / taps : -1;
    }
    if constexpr (Mixed) {
      for (int q = threadIdx.x; q < BM * n_anchors; q += kThreads) {
        const int gr = row0 + q / n_anchors;
        s_w[q] = gr < rows ? wk[(size_t)row0 * n_anchors + q] : 0.f;
      }
    }
    fma_sync();

    // layer 0: no hidden input, only the shared projection + z + bias
    {
      const int w4 = d.width[1] / 4, off = d.xoff[0];
      const bool last = (L == 1);
      for (int q = threadIdx.x; q < BM * w4; q += kThreads) {
        // a warp: 4 rows x 8 quads (128 B of each row's xp; its float4
        // stores at most 2-way bank conflicts, as gemm_pass's epilogue)
        const int g = q >> 5;
        const int m = (g % (BM / 4)) * 4 + (q & 3);
        const int o = 4 * ((g / (BM / 4)) * 8 + ((q >> 2) & 7));
        const int ray = s_ray[m];
        float v[4] = {0.f, 0.f, 0.f, 0.f};
        if (ray >= 0) {
          float sp[4], wzv[4], bv[4];
          shared_proj<Mixed>(sp, xp, s_w, m, ray, n_anchors, d.ntot, off + o);
          load4(wzv, wz + off + o);
          load4(bv, bias + off + o);
          const float zm = s_z[m];
#pragma unroll
          for (int j = 0; j < 4; ++j)
            v[j] = activate(sp[j] + zm * wzv[j] + bv[j], last, d.last_op);
        }
        if (last) {
#pragma unroll
          for (int j = 0; j < 4; ++j)
            if (ray >= 0 && o + j < d.out_dim)
              out[(size_t)(row0 + m) * d.out_dim + o + j] = v[j];
        } else {
          *reinterpret_cast<float4*>(h_a + quad(m, o)) =
              make_float4(v[0], v[1], v[2], v[3]);
        }
      }
    }
    fma_sync();

    for (int i = 1; i < L; ++i) {
      const float* src = (i & 1) ? h_a : h_b;
      float* dst = (i & 1) ? h_b : h_a;
      const int off = d.xoff[i];
      const bool last = (i == L - 1);
      gemm(src, d.width[i], d.width[i + 1], ring,
           [&](int m, int col, const float* acc) {
             // row m's four neighbouring columns col..col + 3
             const int ray = s_ray[m];
             float v[4] = {0.f, 0.f, 0.f, 0.f};
             if (ray >= 0) {
               float sp[4], wzv[4], bv[4];
               if (Pooled && i > pool)
                 view_proj(sp, xp, ray / views, views, inv, d.ntot,
                           off + col);
               else
                 shared_proj<Mixed>(sp, xp, s_w, m, ray, n_anchors, d.ntot,
                                    off + col);
               load4(wzv, wz + off + col);
               load4(bv, bias + off + col);
               const float zm = s_z[m];
#pragma unroll
               for (int j = 0; j < 4; ++j)
                 v[j] = activate(acc[j] + sp[j] + zm * wzv[j] + bv[j], last,
                                 d.last_op);
             }
             if (last) {
               const bool first = !Pooled || (ray >= 0 && ray % views == 0);
               const size_t o = Pooled ? (row0 + m) / views : row0 + m;
#pragma unroll
               for (int j = 0; j < 4; ++j)
                 if (ray >= 0 && first && col + j < d.out_dim)
                   out[o * d.out_dim + col + j] = v[j];
             } else {
               *reinterpret_cast<float4*>(dst + quad(m, col)) =
                   make_float4(v[0], v[1], v[2], v[3]);
             }
           });
      fma_sync();
      if (Pooled && i == pool) {
        pool_views(dst, d.width[i + 1], views, inv);
        fma_sync();
      }
    }
  }
}

template <bool Mixed, bool Scratch>
__global__ void __launch_bounds__(kTileThreads, 1)
    mlp_kernel(const float* __restrict__ xp, const float* __restrict__ z,
               const float* __restrict__ wk, const float* __restrict__ wh,
               const float* __restrict__ wz, const float* __restrict__ bias,
               float* __restrict__ out, int rows, int taps, int n_anchors,
               int w_a, int w_b, float* hs, MlpDims d) {
  mlp_rows<Mixed, Scratch, false>(xp, z, wk, wh, wz, bias, out, rows, taps,
                                  n_anchors, w_a, w_b, hs, d, 1);
}

// The view-pooled per-point form (mlp_rows' Pooled): rows = views * points.
template <bool Scratch>
__global__ void __launch_bounds__(kTileThreads, 1)
    views_mlp_kernel(const float* __restrict__ xp,
                     const float* __restrict__ wh,
                     const float* __restrict__ wz,
                     const float* __restrict__ bias, float* __restrict__ out,
                     int rows, int views, int w_a, int w_b, float* hs,
                     MlpDims d) {
  mlp_rows<false, Scratch, true>(xp, nullptr, nullptr, wh, wz, bias, out,
                                 rows, 1, 1, w_a, w_b, hs, d, views);
}

// gidx, gwgt: null, or the [R, 4] bilinear taps of the gathering form; feat
// is then the [*, C_f] table and is not walked with the rays.
// hs, h_slots: null and 0, or the activation scratch of h_slots blocks
// ([h_slots, BM, w_a + w_b] f32). views > 1: the view-pooled form
// (views_mlp_kernel; R rows, R / views points, one output row a point).
inline int launch(const float* feat, const float* z, const float* wk,
                  float* out, float* xp, int xp_rows, float* hs, int h_slots,
                  const float* wf, const float* wh, const float* wz,
                  const float* b, const MlpDims& d, int R, int taps,
                  int n_anchors, cudaStream_t stream, const int* gidx,
                  const float* gwgt, int views) {
  constexpr int BM = kTileBM;
  const int c_f = d.width[0];
  int max_even = 0, max_odd = 0;
  for (int i = 0; i < d.n_layers; ++i) {
    int& m = (i & 1) ? max_odd : max_even;
    if (d.width[i + 1] > m) m = d.width[i + 1];
  }
  const int w_a = max_even, w_b = max_odd;

  const size_t smem_x = kRingBytes + sizeof(float) * (size_t)BM * c_f;
  if ((hs == nullptr) != (h_slots == 0) || h_slots < 0) return 1013;
  const size_t smem_m =
      kRingBytes + sizeof(float) * (hs ? 0 : (size_t)BM * (w_a + w_b)) +
      BM * (sizeof(float) + sizeof(int)) +
      (size_t)BM * n_anchors * sizeof(float);
  const size_t smem_g = smem_x + (size_t)BM * 4 * (sizeof(int) +
                                                   sizeof(float));
  cudaError_t err =
      gidx ? cudaFuncSetAttribute(gather_xproj_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_g)
           : cudaFuncSetAttribute(xproj_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_x);
  if (err != cudaSuccess) return (int)err;
  auto kernel = hs ? (wk ? mlp_kernel<true, true> : mlp_kernel<false, true>)
                   : (wk ? mlp_kernel<true, false> : mlp_kernel<false, false>);
  auto pooled = hs ? views_mlp_kernel<true> : views_mlp_kernel<false>;
  err = views > 1 ? cudaFuncSetAttribute(
                        pooled, cudaFuncAttributeMaxDynamicSharedMemorySize,
                        (int)smem_m)
                  : cudaFuncSetAttribute(
                        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                        (int)smem_m);
  if (err != cudaSuccess) return (int)err;

  // rays a chunk: all of them if the scratch holds them, else what it
  // holds, cut to whole waves of mlp blocks (one block an SM) where at least
  // one wave fits
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  int chunk = xp_rows / n_anchors;
  if (chunk < 1) return 1006;
  const int wave_rays = sms * BM / taps;
  if (chunk >= R)
    chunk = R;
  else if (wave_rays >= 1 && chunk >= wave_rays)
    chunk -= chunk % wave_rays;
  if (chunk < R) chunk -= chunk % views;   // whole points a chunk
  if (chunk < 1) return 1006;

  for (int r0 = 0; r0 < R; r0 += chunk) {
    const int n = (R - r0 < chunk) ? R - r0 : chunk;
    const int in_rows = n * n_anchors;
    const int row_blocks = (in_rows + BM - 1) / BM;
    if (gidx) {
      gather_xproj_kernel<<<row_blocks, kTileThreads, smem_g, stream>>>(
          feat, gidx + (size_t)r0 * 4, gwgt + (size_t)r0 * 4, wf, xp, in_rows,
          c_f, d.ntot);
    } else {
      dim3 grid_x(n_passes(d.ntot), row_blocks);
      xproj_kernel<<<grid_x, kTileThreads, smem_x, stream>>>(
          feat + (size_t)r0 * n_anchors * c_f, wf, xp, in_rows, c_f, d.ntot);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int rows = n * taps;
    const size_t row0 = (size_t)r0 * taps;
    const int blocks = (rows + BM - 1) / BM;
    const int grid = hs && blocks > h_slots ? h_slots : blocks;
    if (views > 1)
      pooled<<<grid, kTileThreads, smem_m, stream>>>(
          xp, wh, wz, b, out + row0 / views * d.out_dim, rows, views, w_a,
          w_b, hs, d);
    else
      kernel<<<grid, kTileThreads, smem_m, stream>>>(
          xp, z ? z + row0 : nullptr, wk ? wk + row0 * n_anchors : nullptr,
          wh, wz, b, out + row0 * d.out_dim, rows, taps, n_anchors, w_a, w_b,
          hs, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// f32 operands. widths: n_layers + 1 padded widths (multiples of 32):
// [C, out_0, ..., out_(L-1)]. Shapes: feat [R, n_anchors, C]; z [R, taps]
// f32 or null; wk [R, taps, n_anchors] f32 or null (then n_anchors must be
// 1); out [R, taps, out_dim] f32; xp scratch [xp_rows, sum(out_i)] f32,
// xp_rows >= n_anchors; hs null (h_slots 0), or the activation scratch
// [h_slots, BM, w_a + w_b] f32 (w_a, w_b: the widest even- and odd-index
// layer); wf the tile stream of W_f ([sum(out_i), C] cut into passes of
// 512 / 256 / 128 / 32 columns, each pass's [C, pass] block k-major, passes
// in column order); wh the tile streams of layers 1.. concatenated (layer
// i's [out_i, out_(i-1)] cut the same way); wz, b [sum(out_i)] f32.
// gidx [R, 4] i32 and gwgt [R, 4] f32, both or neither: the gathering form,
// in which feat is the [*, C] table that gidx indexes (n_anchors must be 1).
// views > 1: the view-pooled per-point form: feat [R, C] holds `views` rows
// a point, point-major (a power of two up to 32 dividing R; no z, weights or
// gather; taps 1; n_layers >= 3, so the pool layer n_layers / 2 is a hidden
// one), out [R / views, out_dim].
// Returns a cudaError_t (0 on success); 1000 + code for a bad argument.
inline int mlp_forward(const void* feat, const float* z,
                       const float* wk, float* out, float* xp, int xp_rows,
                       float* hs, int h_slots,
                       const void* wf, const void* wh, const float* wz,
                       const float* b, const int* widths, int n_layers,
                       int out_dim, int last_op, int R, int taps,
                       int n_anchors, void* stream,
                       const int* gidx = nullptr,
                       const float* gwgt = nullptr, int views = 1) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 1001;
  if (R < 1 || taps < 1 || out_dim < 1) return 1002;
  if (n_anchors < 1 || n_anchors > kMaxAnchors) return 1007;
  if (wk == nullptr && n_anchors != 1) return 1008;
  if ((gidx == nullptr) != (gwgt == nullptr)) return 1010;
  if (gidx != nullptr && (n_anchors != 1 || wk != nullptr)) return 1010;
  if (views < 1 || kTileBM % views || R % views) return 1014;
  if (views > 1 && (z || wk || gidx || taps != 1 || n_layers < 3))
    return 1015;
  MlpDims d{};
  d.n_layers = n_layers;
  d.out_dim = out_dim;
  d.last_op = last_op;
  long long whoff = 0;
  int ntot = 0;
  for (int i = 0; i <= n_layers; ++i) {
    if (widths[i] <= 0 || widths[i] % 32) return 1003;
    d.width[i] = widths[i];
  }
  if (out_dim > d.width[n_layers]) return 1004;
  for (int i = 0; i < n_layers; ++i) {
    d.xoff[i] = ntot;
    ntot += d.width[i + 1];
    d.whoff[i] = whoff;
    if (i > 0) whoff += (long long)d.width[i + 1] * d.width[i];
  }
  d.ntot = ntot;
  return launch(static_cast<const float*>(feat), z, wk, out, xp, xp_rows, hs,
                h_slots, static_cast<const float*>(wf),
                static_cast<const float*>(wh), wz, b, d, R, taps, n_anchors,
                static_cast<cudaStream_t>(stream), gidx, gwgt, views);
}

}  // namespace
