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
// Operands and sums are f32, on plain FMA.
//
// Bound on the card: operations, at the 67 TFLOP/s of f32 outside the
// tensor cores.
//
// Design:
//  * xproj_kernel computes xp = feat . [W_f0 | ... | W_f(L-1)] once per
//    input row into an f32 scratch [rows, N_tot] in device memory. A TPU
//    core keeps these projections in VMEM; here they would not fit next to
//    the activations in 227 KB of shared memory, so they take one round
//    trip through device memory.
//  * mlp_kernel: a block owns BM flattened (ray, tap) rows and runs all
//    layers with the activations ping-ponging between two shared-memory
//    buffers. Weights stream from L2 in BK-deep K-tiles; the epilogue adds
//    the row's (mixed) shared projection, the rank-1 z term and the bias,
//    activates, and writes the next layer's input (or the output).
//  * the scratch is bounded: the launcher walks the rays in chunks that fit
//    the scratch it is given (whole waves of blocks where they fit), each
//    chunk an xproj launch and an mlp launch on the same stream, so the
//    scratch does not grow with the ray count.
//  * channel widths are padded to multiples of 32 by the packer; T and
//    n_anchors are runtime arguments.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
constexpr int kMaxAnchors = 8;
constexpr int kThreads = 256;

struct MlpDims {
  int n_layers;
  int width[kMaxLayers + 1];     // padded: [C_f, out_0, ..., out_(L-1)]
  int xoff[kMaxLayers];          // column of layer i in xp / w_z / b
  long long whoff[kMaxLayers];   // element offset of W_h^T of layer i >= 1
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

// Block GEMM, f32 operands on plain FMA: each thread owns a 4 x 4 micro
// tile (rows 4*ty + i, cols tx + 32*j); the W tile is staged k-major so a
// warp reads 32 consecutive columns. epi(row, col, v): one element a call.
struct F32Cfg {
  using T = float;
  static constexpr int BM = 32, BN = 128, BK = 16;
  static constexpr int LD_PAD = 4;
  static constexpr int SB_LD = BN + 4;      // W tile stored [BK][BN + 4]
  static constexpr int SB_ELEMS = BK * SB_LD;

  template <class Epi>
  static __device__ void gemm(const T* sA, int lda, int K, const T* gW,
                              int n0, int n_rows, T* sB, Epi epi) {
    const int tid = threadIdx.x, ty = tid >> 5, tx = tid & 31;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int q = tid; q < BN * (BK / 4); q += kThreads) {
        const int r = q / (BK / 4), kq = q % (BK / 4);
        const int n = n0 + r;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n < n_rows)
          v = *reinterpret_cast<const float4*>(gW + (size_t)n * K + k0 + kq * 4);
        sB[(kq * 4 + 0) * SB_LD + r] = v.x;
        sB[(kq * 4 + 1) * SB_LD + r] = v.y;
        sB[(kq * 4 + 2) * SB_LD + r] = v.z;
        sB[(kq * 4 + 3) * SB_LD + r] = v.w;
      }
      __syncthreads();
#pragma unroll 4
      for (int k = 0; k < BK; ++k) {
        float a[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = sA[(ty * 4 + i) * lda + k0 + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = sB[k * SB_LD + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(ty * 4 + i, n0 + tx + 32 * j, acc[i][j]);
  }

  static __device__ __forceinline__ T from_float(float x) { return x; }
  // the 4 values of a 16-byte vector as floats, and back
  static __device__ __forceinline__ void unpack(const uint4& raw, float* f) {
    f[0] = __uint_as_float(raw.x);
    f[1] = __uint_as_float(raw.y);
    f[2] = __uint_as_float(raw.z);
    f[3] = __uint_as_float(raw.w);
  }
  static __device__ __forceinline__ uint4 pack(const float* f) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
  template <int W>
  static __device__ __forceinline__ void store(T* p, const float* v) {
#pragma unroll
    for (int j = 0; j < W; ++j) p[j] = v[j];
  }
};

// Load rows [r0, r0 + BM) of a row-major [n_rows, K] matrix into shared
// memory with row stride lda (rows past n_rows are zero).
template <class T>
__device__ void load_rows(T* dst, int lda, const T* src, int r0, int n_rows,
                          int K, int BM) {
  constexpr int V = 16 / sizeof(T);
  for (int q = threadIdx.x; q < BM * (K / V); q += kThreads) {
    const int m = q / (K / V), kv = q % (K / V);
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + m < n_rows)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(r0 + m) * K + kv * V);
    *reinterpret_cast<uint4*>(dst + m * lda + kv * V) = v;
  }
}

// Make BM input rows in shared memory (row stride lda) by bilinear gather:
// row m = sum_k wgt[m, k] * table[idx[m, k]] over its four taps, table
// row-major [*, K] in the operand type. A thread makes one 16-byte vector of
// a row from four 16-byte loads (a warp reads 512 contiguous bytes of each
// row); products and sums are f32, rounded one by one and
// added in tap order, which is the plain version's arithmetic bit for bit
// (no fused multiply-add), then one rounding to the operand type. s_idx,
// s_wgt: the block's [BM, 4] indices and weights in shared memory; a tap
// outside the image carries a clipped index and weight 0, as do rows past
// the end.
template <class Cfg>
__device__ void gather_rows(typename Cfg::T* dst, int lda,
                            const typename Cfg::T* __restrict__ table,
                            const int* s_idx, const float* s_wgt, int K,
                            int BM) {
  using T = typename Cfg::T;
  constexpr int V = 16 / sizeof(T);
  for (int q = threadIdx.x; q < BM * (K / V); q += kThreads) {
    const int m = q / (K / V), kv = q % (K / V);
    float acc[V];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint4 raw = *reinterpret_cast<const uint4*>(
          table + (size_t)s_idx[m * 4 + k] * K + kv * V);
      const float w = s_wgt[m * 4 + k];
      float f[V];
      Cfg::unpack(raw, f);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float p = __fmul_rn(f[j], w);
        acc[j] = k == 0 ? p : __fadd_rn(acc[j], p);
      }
    }
    *reinterpret_cast<uint4*>(dst + m * lda + kv * V) = Cfg::pack(acc);
  }
}

// W neighbouring f32 values from p (W = 2: one 8-byte load, p aligned).
template <int W>
__device__ __forceinline__ void load_vec(float* v, const float* p) {
  if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x;
    v[1] = t.y;
  } else {
#pragma unroll
    for (int j = 0; j < W; ++j) v[j] = p[j];
  }
}

// The shared projection of row m at W neighbouring columns from col: xp of
// the ray's single input row, or (Mixed) the hat-weighted sum over its
// n_anchors rows (s_w: the block's [BM, n_anchors] weights).
template <int W, bool Mixed>
__device__ __forceinline__ void shared_proj(float* sp,
                                            const float* __restrict__ xp,
                                            const float* s_w, int m, int ray,
                                            int n_anchors, int ntot, int col) {
  if constexpr (Mixed) {
    const float* p = xp + (size_t)ray * n_anchors * ntot + col;
#pragma unroll
    for (int j = 0; j < W; ++j) sp[j] = 0.f;
    for (int k = 0; k < n_anchors; ++k) {
      float t[W];
      load_vec<W>(t, p + (size_t)k * ntot);
      const float wgt = s_w[m * n_anchors + k];
#pragma unroll
      for (int j = 0; j < W; ++j) sp[j] = fmaf(wgt, t[j], sp[j]);
    }
  } else {
    load_vec<W>(sp, xp + (size_t)ray * ntot + col);
  }
}

// Columns [n0, n0 + BN) of xp for the block's BM input rows in sA (rows r0..).
template <class Cfg>
__device__ __forceinline__ void xproj_columns(
    const typename Cfg::T* sA, int lda, int c_f,
    const typename Cfg::T* __restrict__ wf, int n0, int ntot,
    typename Cfg::T* sB, float* __restrict__ xp, int r0, int R) {
  Cfg::gemm(
      sA, lda, c_f, wf, n0, ntot, sB, [&](int m, int col, auto... vs) {
        constexpr int W = sizeof...(vs);
        const float v[W] = {vs...};
        if (r0 + m >= R || col >= ntot) return;
        float* p = xp + (size_t)(r0 + m) * ntot + col;
        if constexpr (W == 2) {
          *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
        } else {
#pragma unroll
          for (int j = 0; j < W; ++j) p[j] = v[j];
        }
      });
}

// xp[R, ntot] = feat[R, C_f] . wf^T, wf^T stored [ntot, C_f].
template <class Cfg>
__global__ void __launch_bounds__(kThreads)
    xproj_kernel(const typename Cfg::T* __restrict__ feat,
                 const typename Cfg::T* __restrict__ wf, float* __restrict__ xp,
                 int R, int c_f, int ntot) {
  using T = typename Cfg::T;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = c_f + Cfg::LD_PAD;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + Cfg::BM * lda;
  const int r0 = blockIdx.y * Cfg::BM;
  load_rows(sA, lda, feat, r0, R, c_f, Cfg::BM);
  __syncthreads();
  xproj_columns<Cfg>(sA, lda, c_f, wf, blockIdx.x * Cfg::BN, ntot, sB, xp, r0,
                     R);
}

// The same projection with the input rows gathered inside the kernel:
// row r = sum_k wgt[r, k] * table[idx[r, k]] (gather_rows), never written to
// device memory. The grid is the row blocks alone: a block gathers its BM
// rows once and walks every column tile itself.
template <class Cfg>
__global__ void __launch_bounds__(kThreads)
    gather_xproj_kernel(const typename Cfg::T* __restrict__ table,
                        const int* __restrict__ idx,
                        const float* __restrict__ wgt,
                        const typename Cfg::T* __restrict__ wf,
                        float* __restrict__ xp, int R, int c_f, int ntot) {
  using T = typename Cfg::T;
  constexpr int BM = Cfg::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = c_f + Cfg::LD_PAD;
  T* sA = reinterpret_cast<T*>(smem);
  T* sB = sA + BM * lda;
  int* s_idx = reinterpret_cast<int*>(sB + Cfg::SB_ELEMS);
  float* s_wgt = reinterpret_cast<float*>(s_idx + BM * 4);
  const int r0 = blockIdx.x * BM;
  for (int q = threadIdx.x; q < BM * 4; q += kThreads) {
    const bool live = r0 + q / 4 < R;
    s_idx[q] = live ? idx[(size_t)r0 * 4 + q] : 0;
    s_wgt[q] = live ? wgt[(size_t)r0 * 4 + q] : 0.f;
  }
  __syncthreads();
  gather_rows<Cfg>(sA, lda, table, s_idx, s_wgt, c_f, BM);
  __syncthreads();
  for (int n0 = 0; n0 < ntot; n0 += Cfg::BN)
    xproj_columns<Cfg>(sA, lda, c_f, wf, n0, ntot, sB, xp, r0, R);
}

// The per-(ray, tap) MLP over BM flattened rows (row = ray * taps + tap).
// z may be null (no z term). Mixed: wk holds the rows' hat weights over the
// ray's n_anchors input rows; else a ray has one input row of weight 1.
template <class Cfg, bool Mixed>
__global__ void __launch_bounds__(kThreads)
    mlp_kernel(const float* __restrict__ xp, const float* __restrict__ z,
               const float* __restrict__ wk,
               const typename Cfg::T* __restrict__ wh,
               const float* __restrict__ wz, const float* __restrict__ bias,
               float* __restrict__ out, int rows, int taps, int n_anchors,
               int ld_a, int ld_b, MlpDims d) {
  using T = typename Cfg::T;
  constexpr int BM = Cfg::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  T* h_a = reinterpret_cast<T*>(smem);
  T* h_b = h_a + BM * ld_a;
  T* sB = h_b + BM * ld_b;
  float* s_z = reinterpret_cast<float*>(sB + Cfg::SB_ELEMS);
  int* s_ray = reinterpret_cast<int*>(s_z + BM);
  float* s_w = reinterpret_cast<float*>(s_ray + BM);

  const int row0 = blockIdx.x * BM;
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
  __syncthreads();

  const int L = d.n_layers;
  // layer 0: no hidden input, only the shared projection + z + bias
  {
    const int w0 = d.width[1], off = d.xoff[0];
    const bool last = (L == 1);
    for (int q = threadIdx.x; q < BM * w0; q += kThreads) {
      const int m = q / w0, o = q % w0;
      const int ray = s_ray[m];
      float v = 0.f;
      if (ray >= 0) {
        shared_proj<1, Mixed>(&v, xp, s_w, m, ray, n_anchors, d.ntot, off + o);
        v = v + s_z[m] * wz[off + o] + bias[off + o];
        v = activate(v, last, d.last_op);
      }
      if (last) {
        if (ray >= 0 && o < d.out_dim)
          out[(size_t)(row0 + m) * d.out_dim + o] = v;
      } else {
        h_a[m * ld_a + o] = Cfg::from_float(v);
      }
    }
  }
  __syncthreads();

  for (int i = 1; i < L; ++i) {
    const T* src = (i & 1) ? h_a : h_b;
    T* dst = (i & 1) ? h_b : h_a;
    const int lds = (i & 1) ? ld_a : ld_b;
    const int ldd = (i & 1) ? ld_b : ld_a;
    const int K = d.width[i], N = d.width[i + 1], off = d.xoff[i];
    const bool last = (i == L - 1);
    const T* w = wh + d.whoff[i];
    for (int n0 = 0; n0 < N; n0 += Cfg::BN) {
      Cfg::gemm(src, lds, K, w, n0, N, sB, [&](int m, int col, auto... vs) {
        // W neighbouring columns of row m (N is a multiple of W)
        constexpr int W = sizeof...(vs);
        const float acc[W] = {vs...};
        if (col >= N) return;
        const int ray = s_ray[m];
        float v[W];
#pragma unroll
        for (int j = 0; j < W; ++j) v[j] = 0.f;
        if (ray >= 0) {
          float sp[W], wzv[W], bv[W];
          shared_proj<W, Mixed>(sp, xp, s_w, m, ray, n_anchors, d.ntot,
                                off + col);
          load_vec<W>(wzv, wz + off + col);
          load_vec<W>(bv, bias + off + col);
          const float zm = s_z[m];
#pragma unroll
          for (int j = 0; j < W; ++j)
            v[j] = activate(acc[j] + sp[j] + zm * wzv[j] + bv[j], last,
                            d.last_op);
        }
        if (last) {
#pragma unroll
          for (int j = 0; j < W; ++j)
            if (ray >= 0 && col + j < d.out_dim)
              out[(size_t)(row0 + m) * d.out_dim + col + j] = v[j];
        } else {
          Cfg::template store<W>(dst + m * ldd + col, v);
        }
      });
    }
    __syncthreads();
  }
}

// gidx, gwgt: null, or the [R, 4] bilinear taps of the gathering form; feat
// is then the [*, C_f] table and is not walked with the rays.
template <class Cfg>
int launch(const void* feat, const float* z, const float* wk, float* out,
           float* xp, int xp_rows, const void* wf, const void* wh,
           const float* wz, const float* b, const MlpDims& d, int R, int taps,
           int n_anchors, cudaStream_t stream, const int* gidx,
           const float* gwgt) {
  using T = typename Cfg::T;
  const int c_f = d.width[0];
  int max_even = 0, max_odd = 0;
  for (int i = 0; i < d.n_layers; ++i) {
    int& m = (i & 1) ? max_odd : max_even;
    if (d.width[i + 1] > m) m = d.width[i + 1];
  }
  const int ld_a = max_even + Cfg::LD_PAD;
  const int ld_b = max_odd + Cfg::LD_PAD;

  const size_t smem_x =
      sizeof(T) * ((size_t)Cfg::BM * (c_f + Cfg::LD_PAD) + Cfg::SB_ELEMS);
  const size_t smem_m =
      sizeof(T) * ((size_t)Cfg::BM * (ld_a + ld_b) + Cfg::SB_ELEMS) +
      Cfg::BM * (sizeof(float) + sizeof(int)) +
      (size_t)Cfg::BM * n_anchors * sizeof(float);
  const size_t smem_g = smem_x + (size_t)Cfg::BM * 4 * (sizeof(int) +
                                                        sizeof(float));
  cudaError_t err =
      gidx ? cudaFuncSetAttribute(gather_xproj_kernel<Cfg>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_g)
           : cudaFuncSetAttribute(xproj_kernel<Cfg>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_x);
  if (err != cudaSuccess) return (int)err;
  auto kernel = wk ? mlp_kernel<Cfg, true> : mlp_kernel<Cfg, false>;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  const int wave_rays = sms * Cfg::BM / taps;
  if (chunk >= R)
    chunk = R;
  else if (wave_rays >= 1 && chunk >= wave_rays)
    chunk -= chunk % wave_rays;

  for (int r0 = 0; r0 < R; r0 += chunk) {
    const int n = (R - r0 < chunk) ? R - r0 : chunk;
    const int in_rows = n * n_anchors;
    const int row_blocks = (in_rows + Cfg::BM - 1) / Cfg::BM;
    if (gidx) {
      gather_xproj_kernel<Cfg><<<row_blocks, kThreads, smem_g, stream>>>(
          static_cast<const T*>(feat), gidx + (size_t)r0 * 4,
          gwgt + (size_t)r0 * 4, static_cast<const T*>(wf), xp, in_rows, c_f,
          d.ntot);
    } else {
      dim3 grid_x((d.ntot + Cfg::BN - 1) / Cfg::BN, row_blocks);
      xproj_kernel<Cfg><<<grid_x, kThreads, smem_x, stream>>>(
          static_cast<const T*>(feat) + (size_t)r0 * n_anchors * c_f,
          static_cast<const T*>(wf), xp, in_rows, c_f, d.ntot);
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;

    const int rows = n * taps;
    const size_t row0 = (size_t)r0 * taps;
    kernel<<<(rows + Cfg::BM - 1) / Cfg::BM, kThreads, smem_m, stream>>>(
        xp, z ? z + row0 : nullptr, wk ? wk + row0 * n_anchors : nullptr,
        static_cast<const T*>(wh), wz, b, out + row0 * d.out_dim, rows, taps,
        n_anchors, ld_a, ld_b, d);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// f32 operands. widths: n_layers + 1 padded
// widths (multiples of 32): [C, out_0, ..., out_(L-1)]. Shapes:
// feat [R, n_anchors, C]; z [R, taps] f32 or null; wk [R, taps, n_anchors]
// f32 or null (then n_anchors must be 1); out [R, taps, out_dim] f32;
// xp scratch [xp_rows, sum(out_i)] f32, xp_rows >= n_anchors; wf
// [sum(out_i), C]; wh the W_h^T of layers 1.. concatenated
// ([out_i, out_(i-1)] each); wz, b [sum(out_i)] f32.
// gidx [R, 4] i32 and gwgt [R, 4] f32, both or neither: the gathering form,
// in which feat is the [*, C] table that gidx indexes (n_anchors must be 1).
// Returns a cudaError_t (0 on success); 1000 + code for a bad argument.
inline int mlp_forward(const void* feat, const float* z,
                       const float* wk, float* out, float* xp, int xp_rows,
                       const void* wf, const void* wh, const float* wz,
                       const float* b, const int* widths, int n_layers,
                       int out_dim, int last_op, int R, int taps,
                       int n_anchors, void* stream,
                       const int* gidx = nullptr,
                       const float* gwgt = nullptr) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 1001;
  if (R < 1 || taps < 1 || out_dim < 1) return 1002;
  if (n_anchors < 1 || n_anchors > kMaxAnchors) return 1007;
  if (wk == nullptr && n_anchors != 1) return 1008;
  if ((gidx == nullptr) != (gwgt == nullptr)) return 1010;
  if (gidx != nullptr && (n_anchors != 1 || wk != nullptr)) return 1010;
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
  return launch<F32Cfg>(feat, z, wk, out, xp, xp_rows, wf, wh, wz, b, d, R,
                        taps, n_anchors, static_cast<cudaStream_t>(stream),
                        gidx, gwgt);
}

}  // namespace
