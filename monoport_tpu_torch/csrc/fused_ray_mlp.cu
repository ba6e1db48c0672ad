// Ray-structured skip-concat MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel monoport_tpu/ops/pallas/fused_ray_mlp.py::_ray_kernel.
// Per ray r with feature feat[r] (C_f wide) and T z-taps z[r, t], layer i of
// the PIFu head computes, for every tap,
//     acc_i = xp_i[r] + z[r, t] * w_z[i] + b[i] (+ h_{i-1} . W_h[i], i > 0)
// where xp_i[r] = feat[r] . W_f[i] is shared by all T taps of the ray;
// leaky-ReLU 0.01 between layers, sigmoid / tanh / none after the last.
// Operands are bf16 or f32, accumulation is f32; xp and h . W_h stay f32
// and h is rounded to the operand type only after each activation.
//
// Bound on the card: operations. The frame's launches do 40-340 GFLOP each
// against a few MB of weights and inputs, far above the ~295 FLOP/byte
// ridge of an H100 in bf16.
//
// Design (first, simple version; wgmma/TMA come later):
//  * kernel 1 (xproj_kernel) computes xp = feat . [W_f0 | ... | W_f(L-1)]
//    once per ray into an f32 scratch [R, N_tot] in device memory. The TPU
//    design kept these projections in VMEM; here they would not fit next to
//    the activations in 227 KB of shared memory, so they take one round
//    trip through device memory (L2 for the small launches).
//  * kernel 2 (mlp_kernel): a block owns BM flattened (ray, tap) rows and
//    runs all layers with the activations ping-ponging between two
//    shared-memory buffers (64 x 1024 + 64 x 520 bf16 for the PIFu heads).
//    Weights stream from L2 in BK-deep K-tiles through a double-buffered
//    cp.async ring; the epilogue adds the row's shared projection, the
//    rank-1 z term and the bias, activates, and writes the next layer's
//    input (or the output).
//  * bf16 products run on mma.sync m16n8k16 tensor-core instructions; f32
//    runs on plain FMA (no TF32), so it matches the f32 reference tightly.
//  * channel widths are padded to multiples of 32 by the packer; T is a
//    runtime argument.
//
// Plain C interface, loaded through ctypes; launches on the given stream
// and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLayers = 8;
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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a,
                                         const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// ---------------------------------------------------------------------------
// Block GEMM, bf16 operands on tensor cores:
//   C[BM, BN] = A[BM, K] (shared, row-major, stride lda)
//             . W^T rows [n0, n0 + BN) of gW [n_rows, K] (device memory).
// 8 warps as 2 (rows) x 4 (cols), each a 32 x 32 tile of m16n8 fragments.
// epi(row, col, value) receives every element of the block tile.
struct Bf16Cfg {
  using T = __nv_bfloat16;
  static constexpr int BM = 64, BN = 128, BK = 32;
  static constexpr int LD_PAD = 8;          // row pad of the A buffers
  static constexpr int SB_LD = BK + 8;      // W tile stored [BN][BK + 8]
  static constexpr int SB_ELEMS = 2 * BN * SB_LD;

  template <class Epi>
  static __device__ void gemm(const T* sA, int lda, int K, const T* gW,
                              int n0, int n_rows, T* sB, Epi epi) {
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int wm = warp >> 2, wn = warp & 3;
    const int g = lane >> 2, c = lane & 3;
    float acc[2][4][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

    const int ktiles = K / BK;
    auto load_tile = [&](int kt, int buf) {
      T* base = sB + buf * BN * SB_LD;
      for (int q = tid; q < BN * (BK / 8); q += kThreads) {
        const int r = q / (BK / 8), seg = q % (BK / 8);
        T* dst = base + r * SB_LD + seg * 8;
        const int n = n0 + r;
        if (n < n_rows)
          cp_async16(dst, gW + (size_t)n * K + kt * BK + seg * 8);
        else
          *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
      }
      cp_async_commit();
    };

    load_tile(0, 0);
    for (int kt = 0; kt < ktiles; ++kt) {
      if (kt + 1 < ktiles) {
        load_tile(kt + 1, (kt + 1) & 1);
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const T* b = sB + (kt & 1) * BN * SB_LD;
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        uint32_t af[2][4], bfr[4][2];
        const int k = kt * BK + kk + 2 * c;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const T* p = sA + (wm * 32 + mt * 16 + g) * lda + k;
          af[mt][0] = ld32(p);
          af[mt][1] = ld32(p + 8 * lda);
          af[mt][2] = ld32(p + 8);
          af[mt][3] = ld32(p + 8 * lda + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const T* p = b + (wn * 32 + nt * 8 + g) * SB_LD + kk + 2 * c;
          bfr[nt][0] = ld32(p);
          bfr[nt][1] = ld32(p + 8);
        }
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], af[mt], bfr[nt]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          epi(wm * 32 + mt * 16 + g + (e >> 1) * 8,
              n0 + wn * 32 + nt * 8 + 2 * c + (e & 1), acc[mt][nt][e]);
  }

  static __device__ __forceinline__ T from_float(float x) {
    return __float2bfloat16(x);
  }
};

// Block GEMM, f32 operands on plain FMA: each thread owns a 4 x 4 micro
// tile (rows 4*ty + i, cols tx + 32*j); the W tile is staged k-major so a
// warp reads 32 consecutive columns.
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
  Cfg::gemm(sA, lda, c_f, wf, blockIdx.x * Cfg::BN, ntot, sB,
            [&](int m, int col, float v) {
              if (r0 + m < R && col < ntot) xp[(size_t)(r0 + m) * ntot + col] = v;
            });
}

// The per-(ray, tap) MLP over BM flattened rows (row = ray * taps + tap).
template <class Cfg>
__global__ void __launch_bounds__(kThreads)
    mlp_kernel(const float* __restrict__ xp, const float* __restrict__ z,
               const typename Cfg::T* __restrict__ wh,
               const float* __restrict__ wz, const float* __restrict__ bias,
               float* __restrict__ out, int rows, int taps, int ld_a, int ld_b,
               MlpDims d) {
  using T = typename Cfg::T;
  constexpr int BM = Cfg::BM;
  extern __shared__ __align__(16) unsigned char smem[];
  T* h_a = reinterpret_cast<T*>(smem);
  T* h_b = h_a + BM * ld_a;
  T* sB = h_b + BM * ld_b;
  float* s_z = reinterpret_cast<float*>(sB + Cfg::SB_ELEMS);
  int* s_ray = reinterpret_cast<int*>(s_z + BM);

  const int row0 = blockIdx.x * BM;
  for (int m = threadIdx.x; m < BM; m += kThreads) {
    const int gr = row0 + m;
    s_z[m] = gr < rows ? z[gr] : 0.f;
    s_ray[m] = gr < rows ? gr / taps : -1;
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
        v = xp[(size_t)ray * d.ntot + off + o] + s_z[m] * wz[off + o] +
            bias[off + o];
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
      Cfg::gemm(src, lds, K, w, n0, N, sB, [&](int m, int col, float acc) {
        if (col >= N) return;
        const int ray = s_ray[m];
        float v = 0.f;
        if (ray >= 0) {
          v = acc + xp[(size_t)ray * d.ntot + off + col] +
              s_z[m] * wz[off + col] + bias[off + col];
          v = activate(v, last, d.last_op);
        }
        if (last) {
          if (ray >= 0 && col < d.out_dim)
            out[(size_t)(row0 + m) * d.out_dim + col] = v;
        } else {
          dst[m * ldd + col] = Cfg::from_float(v);
        }
      });
    }
    __syncthreads();
  }
}

template <class Cfg>
int launch(const void* feat, const float* z, float* out, float* xp,
           const void* wf, const void* wh, const float* wz, const float* b,
           const MlpDims& d, int R, int taps, cudaStream_t stream) {
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
      Cfg::BM * (sizeof(float) + sizeof(int));
  cudaError_t err = cudaFuncSetAttribute(
      xproj_kernel<Cfg>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_x);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(mlp_kernel<Cfg>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_m);
  if (err != cudaSuccess) return (int)err;

  dim3 grid_x((d.ntot + Cfg::BN - 1) / Cfg::BN, (R + Cfg::BM - 1) / Cfg::BM);
  xproj_kernel<Cfg><<<grid_x, kThreads, smem_x, stream>>>(
      static_cast<const T*>(feat), static_cast<const T*>(wf), xp, R, c_f,
      d.ntot);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int rows = R * taps;
  mlp_kernel<Cfg><<<(rows + Cfg::BM - 1) / Cfg::BM, kThreads, smem_m,
                    stream>>>(xp, z, static_cast<const T*>(wh), wz, b, out,
                              rows, taps, ld_a, ld_b, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 operands. widths: n_layers + 1 padded
// widths (multiples of 32): [C_f, out_0, ..., out_(L-1)]. Shapes:
// feat [R, C_f]; z [R, taps] f32; out [R, taps, out_dim] f32;
// xp scratch [R, sum(out_i)] f32; wf [sum(out_i), C_f]; wh the W_h^T of
// layers 1.. concatenated ([out_i, out_(i-1)] each); wz, b [sum(out_i)] f32.
// Returns a cudaError_t (0 on success); 1000 + code for a bad argument.
int fused_ray_mlp_forward(int dtype, const void* feat, const float* z,
                          float* out, float* xp, const void* wf,
                          const void* wh, const float* wz, const float* b,
                          const int* widths, int n_layers, int out_dim,
                          int last_op, int R, int taps, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers) return 1001;
  if (R < 1 || taps < 1 || out_dim < 1) return 1002;
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch<Bf16Cfg>(feat, z, out, xp, wf, wh, wz, b, d, R, taps, s);
  if (dtype == 0)
    return launch<F32Cfg>(feat, z, out, xp, wf, wh, wz, b, d, R, taps, s);
  return 1005;
}

}  // extern "C"
