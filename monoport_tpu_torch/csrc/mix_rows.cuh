// The weighted-row pass of the bf16 routes of kernels 3 and 4, for Hopper
// (sm_90a): fused_ray_mlp.cu (the anchored ray MLP) and fused_gather_mlp.cu
// (the ray MLP with the bilinear gather) include this file and add one plain
// C entry point each.
//
// It serves the TPU kernels
//  * monoport_tpu/ops/pallas/fused_ray_mlp.py::_anchor_kernel: tap t of ray r
//    mixes the ray's K anchor features with its K hat weights. W_f is
//    linear, so sum_k w_k (x_k W_f) = (sum_k w_k x_k) W_f: the mixed row of
//    the tap goes through the wgmma kernel (wgmma_mlp.cuh, AnchorEpilogue)
//    as a row of its own;
//  * monoport_tpu/ops/pallas/fused_gather_mlp.py::_gather_ray_kernel: a ray's
//    feature is the bilinear sample of a [H*W, C] row table, its four tap
//    rows combined in f32 and rounded to bf16 (the TPU kernel's own order),
//    and the ray MLP's wgmma kernel (RayEpilogue) follows.
//
// It computes, for m < M and c < c_pad, the f32 sum
//     s[m, c] = sum_{j<J} w[m, j] * f32(table[row(m, j), c]),   c < c_f
// with row(m, j) = idx[m, j] when an index array is given (the gather: J =
// 4), else (m / taps) * J + j (the anchors: J = K anchors of ray m / taps,
// read where they lie, with no copy), and writes
//     out[m, c] = bf16(s[m, c])                                    (hi)
//     out[m, c_pad + c] = bf16(s[m, c] - f32(out[m, c]))  with split (lo)
// and 0 for c_f <= c < c_pad. Products and sums are f32, rounded at each
// step (no fused multiply-add) in the fixed order j = 0..J-1, as the plain
// version (ops/cuda/mix_rows.py: mix_rows_plain) computes them; s - hi is
// exact in f32.
//
// The split is the anchored route's: the TPU kernel mixes f32 projections,
// and one rounding of the mixed row to bf16 (2^-9 relative) took the
// committed netG's outputs up to 3.1e-2 from them (p99.9 1.2e-2, 2,304 rays
// x 5 anchors x 6 taps on an H100), past the 2e-2 of the bf16 rows. hi + lo
// carries ~16 bits of the sum into the GEMM, against [W_f; W_f]: 4.7e-3
// (p99.9 1.7e-3) at the same inputs. The gather needs no split: its one
// rounding is the TPU kernel's own.
// A term whose weight is exactly 0 is skipped: a hat weight is non-zero for
// at most two anchors and a clamped out-of-image tap weighs 0, so the sum of
// finite rows is unchanged.
//
// A thread makes 8 columns of one output row: one 16-byte load of each
// table row it mixes and one 16-byte store, neighbouring threads on
// neighbouring columns; a row's weights and indices are one broadcast load
// a warp.
//
// Bound: bytes. Each table row that a non-zero weight touches is read once,
// w (and idx) once, each output row written once: at the hierarchy frame's
// refine (36,864 rays x 3 anchors x 6 taps, netG's 256 columns) 57 MB of
// anchors in and 226 MB of hi + lo rows out, ~0.085 ms at 3.35 TB/s, a few
// % of the MLP launch that follows.
//
// Why a pass and not the wgmma kernel's producer: that kernel streams its
// x tile again for every pass of every layer (wgmma_mlp.cuh: x does not
// stay resident), so mixing in the producer would redo the mix 5-6 times a
// block, and would need K staging tiles in the ~26 KB of shared memory the
// kernel leaves free (205,856 of 232,448 B). The pass writes each mixed row
// once, and the wgmma kernel reads it as it reads any x.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMixMaxTerms = 8;
constexpr int kMixThreads = 256;

__global__ void __launch_bounds__(kMixThreads)
    mix_rows_kernel(const __nv_bfloat16* __restrict__ table, int ld, int c_f,
                    const float* __restrict__ w, const int* __restrict__ idx,
                    int J, int taps, __nv_bfloat16* __restrict__ out, int M,
                    int c_pad, int split) {
  const int vpr = c_pad / 8;
  const long long g = (long long)blockIdx.x * kMixThreads + threadIdx.x;
  if (g >= (long long)M * vpr) return;
  const int m = (int)(g / vpr), c = (int)(g % vpr) * 8;
  float acc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) acc[e] = 0.f;
  if (c < c_f) {
    const float* wm = w + (size_t)m * J;
    const int* im = idx ? idx + (size_t)m * J : nullptr;
    const long long first = (long long)(m / taps) * J;
    for (int j = 0; j < J; ++j) {
      const float wj = __ldg(wm + j);
      if (wj == 0.f) continue;
      const long long row = im ? (long long)__ldg(im + j) : first + j;
      const uint4 v =
          __ldg(reinterpret_cast<const uint4*>(table + row * ld + c));
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(p[e]);
        acc[2 * e] = __fadd_rn(acc[2 * e], __fmul_rn(wj, f.x));
        acc[2 * e + 1] = __fadd_rn(acc[2 * e + 1], __fmul_rn(wj, f.y));
      }
    }
  }
  uint4 hi, lo;
  __nv_bfloat162* qh = reinterpret_cast<__nv_bfloat162*>(&hi);
  __nv_bfloat162* ql = reinterpret_cast<__nv_bfloat162*>(&lo);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float a = c + 2 * e < c_f ? acc[2 * e] : 0.f;
    const float b = c + 2 * e + 1 < c_f ? acc[2 * e + 1] : 0.f;
    qh[e] = __floats2bfloat162_rn(a, b);
    const float2 h = __bfloat1622float2(qh[e]);
    ql[e] = __floats2bfloat162_rn(__fsub_rn(a, h.x), __fsub_rn(b, h.y));
  }
  __nv_bfloat16* o = out + (size_t)m * (split ? 2 * c_pad : c_pad) + c;
  *reinterpret_cast<uint4*>(o) = hi;
  if (split) *reinterpret_cast<uint4*>(o + c_pad) = lo;
}

// table [n, ld] bf16 (ld a multiple of 8, c_f <= ld, 16-byte aligned); w
// [M, J] f32; idx [M, J] i32 rows of the table, or null for the anchors of
// ray m / taps; out [M, c_pad] bf16, or [M, 2 c_pad] (hi | lo) with split
// (c_pad a multiple of 8, >= c_f). Returns a cudaError_t, or 1000 + code for
// a bad argument.
inline int mix_rows_launch(const void* table, int ld, int c_f, const float* w,
                           const int* idx, int J, int taps, void* out, int M,
                           int c_pad, int split, void* stream) {
  if (table == nullptr || w == nullptr || out == nullptr) return 1009;
  if (J < 1 || J > kMixMaxTerms) return 1007;
  if (M < 1 || taps < 1 || (idx == nullptr && M % taps)) return 1002;
  if (c_f < 1 || ld % 8 || c_f > ld || c_pad % 8 || c_pad < c_f)
    return 1003;
  if (reinterpret_cast<uintptr_t>(table) % 16 ||
      reinterpret_cast<uintptr_t>(out) % 16)
    return 1013;
  const long long threads = (long long)M * (c_pad / 8);
  const long long blocks = (threads + kMixThreads - 1) / kMixThreads;
  if (blocks > 0x7fffffffll) return 1002;
  mix_rows_kernel<<<(unsigned)blocks, kMixThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(table), ld, c_f, w, idx, J, taps,
      static_cast<__nv_bfloat16*>(out), M, c_pad, split);
  return (int)cudaGetLastError();
}

}  // namespace
