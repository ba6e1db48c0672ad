// Ray-structured and anchored skip-concat MLPs for Hopper (sm_90a).
//
// The ray MLP replaces the TPU kernel
// monoport_tpu/ops/pallas/fused_ray_mlp.py::_ray_kernel: per ray one feature
// row shared by T z-taps, layer i computing for tap t
//     acc_i = feat[r] . W_f[i] + z[r, t] * w_z[i] + b[i]  (+ h . W_h[i]),
// leaky-ReLU 0.01 between layers, sigmoid / tanh / none after the last.
// Two dtypes, two routes:
//  * bf16 (fused_ray_mlp_wgmma_forward): the wgmma kernel of wgmma_mlp.cuh
//    (one pass, one launch, no scratch; design there) with RayEpilogue. A
//    row is a (ray, tap): a block owns 64 rays at one tap, its x tile the
//    rays' features by the TMA tensor map, and adds z * w_z + b in f32 in
//    the layer epilogue. The TPU kernel computes feat . W_f once a ray and
//    shares it across the taps; here it is recomputed for every tap (1.53x
//    the operations of the bound at T = 6, 1.68x at T = 33, 1x at T = 1 for
//    netG): 64 rays x 1,952 f32 projection columns (500 KB) cannot stay in
//    shared memory. The route it replaced, a projection pass through a
//    device-memory scratch then mma.sync layers, took 3.7x as long at
//    36,864 rays x 6 taps on an H100 (PERF.md).
//  * f32 (fused_ray_mlp_forward): the parity route on plain FMA,
//    mlp_tiles.cuh (an xproj pass into a bounded f32 scratch, then the layer
//    kernel). wgmma has no f32 operands, and TF32 would break the 2e-5
//    parity with the f32 reference.
//
// The anchored MLP replaces
// monoport_tpu/ops/pallas/fused_ray_mlp.py::_anchor_kernel: per ray K anchor
// feature rows; each tap mixes their projections with its K hat weights,
//     acc_i = sum_k w[r, t, k] * (feat[r, k] . W_f[i]) + z * w_z[i] + b[i]
//             (+ h . W_h[i]).
// The TPU kernel's (tiles, taps) grid, its 8-lane mix tensor and its
// per-layer scratch answer a scoped-VMEM limit and have no counterpart here.
// Two dtypes, two routes:
//  * bf16: W_f is linear, so the mix moves ahead of it: sum_k w_k (x_k W_f)
//    = (sum_k w_k x_k) W_f. mix_anchor_rows (mix_rows.cuh, bound by bytes)
//    writes each tap's mixed row [R * T, 2 C_f] as a row of its own, its
//    f32 sum split into bf16 hi | lo halves; then one launch of the wgmma
//    kernel (fused_anchor_mlp_wgmma_forward, AnchorEpilogue: RayEpilogue at
//    one tap) runs the MLP over the R * T rows, every layer reading
//    [W_f; W_f] against [hi | lo]. The TPU kernel projects the K anchors
//    once a ray and mixes the f32 projections: one bf16 rounding of the
//    mixed row (2^-9 relative) took the committed netG's outputs 3.1e-2
//    from that on an H100, past the 2e-2 bf16 tolerance; hi + lo carries
//    ~16 bits of it (max errors 4.7e-3-1.4e-2, p99.9 1.7e-3-2.0e-3 at the
//    frames' shapes). This route projects each tap's two halves, T (2 c_f
//    sum(O) + M_tap) against K c_f sum(O) + T M_tap multiply-adds (1.79x
//    at K 3, T 6; 1.52x at K 5, T 6 for netG). The route it replaced (an
//    xproj pass of the anchors into a 64 MiB f32 scratch, then mma.sync
//    layers mixing in the epilogue) took 4.8x as long at 36,864 rays x 3
//    anchors x 6 taps on an H100 (PERF.md).
//  * f32 (fused_anchor_mlp_forward): the parity route, mlp_tiles.cuh (the K
//    projections of a ray are K rows of one xproj pass into a bounded f32
//    scratch; the layer epilogue mixes them in f32 from the block's K
//    weights a row).
//
// All are bound by operations on paper (see the headers) but for the mix
// pass, which is bound by bytes. Plain C interface, loaded through ctypes;
// each call launches on the given stream and returns cudaGetLastError(), or
// 1000 + code for a bad argument.

#include "mix_rows.cuh"
#include "wgmma_mlp.cuh"

namespace {

template <bool Math>
int ray_launch(const void* feat, float* out, const void* w, const float* bwz,
               const int* widths, int n_layers, int c_f, int out_dim,
               int last_op, int R, const float* z, int taps, void* stream) {
  if (z == nullptr) return 1009;
  WgmmaDims d;
  const int bad = wgmma_dims(&d, widths, n_layers, c_f, out_dim, last_op);
  if (bad) return bad;
  if (R < 1 || taps < 1) return 1002;
  const RayEpilogue epi{reinterpret_cast<const float4*>(bwz), z, out, R, taps};
  return wgmma_launch<RayEpilogue, Math>(
      feat, R, w, epi, (long long)taps * ((R + kBM - 1) / kBM), d, stream);
}

template <bool Math>
int anchor_launch(const void* x, float* out, const void* w, const float* bwz,
                  const int* widths, int n_layers, int c_f, int out_dim,
                  int last_op, int M, const float* z, int taps,
                  void* stream) {
  if (z == nullptr) return 1009;
  WgmmaDims d;
  const int bad = wgmma_dims(&d, widths, n_layers, c_f, out_dim, last_op);
  if (bad) return bad;
  if (M < 1 || taps != 1) return 1002;
  const AnchorEpilogue epi{
      {reinterpret_cast<const float4*>(bwz), z, out, M, 1}};
  return wgmma_launch<AnchorEpilogue, Math>(x, M, w, epi,
                                            (M + kBM - 1) / kBM, d, stream);
}

}  // namespace

extern "C" {

// The f32 route. feat [R, C_f] f32; z [R, taps] f32; out [R, taps,
// out_dim] f32. The other arguments as mlp_forward (mlp_tiles.cuh).
int fused_ray_mlp_forward(const void* feat, const float* z, float* out,
                          float* xp, int xp_rows, const void* wf,
                          const void* wh, const float* wz, const float* b,
                          const int* widths, int n_layers, int out_dim,
                          int last_op, int R, int taps, void* stream) {
  if (z == nullptr) return 1009;
  return mlp_forward(feat, z, nullptr, out, xp, xp_rows, wf, wh, wz, b,
                     widths, n_layers, out_dim, last_op, R, taps, 1, stream);
}

// The bf16 route. feat [R, c_f] bf16 (c_f a multiple of 32); w the packed
// weight stream (ops/cuda/wgmma.py: tile_stream); bwz [2 sum(widths)] f32,
// {b, b, w_z, w_z} a column pair at kernel widths; widths the n_layers
// kernel widths; z [R, taps] f32; out [R, taps, out_dim] f32. Returns a
// cudaError_t, or 1000 + code for a bad argument.
int fused_ray_mlp_wgmma_forward(const void* feat, float* out, const void* w,
                                const float* bwz, const int* widths,
                                int n_layers, int c_f, int out_dim,
                                int last_op, int R, const float* z, int taps,
                                void* stream) {
  return ray_launch<true>(feat, out, w, bwz, widths, n_layers, c_f, out_dim,
                          last_op, R, z, taps, stream);
}

// The same launch with the math off: the ring streams every weight and x
// tile and nothing is computed or written (out is not touched).
int fused_ray_mlp_wgmma_stream(const void* feat, float* out, const void* w,
                               const float* bwz, const int* widths,
                               int n_layers, int c_f, int out_dim,
                               int last_op, int R, const float* z, int taps,
                               void* stream) {
  return ray_launch<false>(feat, out, w, bwz, widths, n_layers, c_f, out_dim,
                           last_op, R, z, taps, stream);
}

// The bf16 route's pass: the mixed rows of every (ray, tap). anchors
// [R * K, ld] bf16 (the K anchor rows of each ray, c_f columns used); w
// [M, K] f32 hat weights, M = R * taps; idx must be null and split 1; out
// [M, 2 c_pad] bf16, hi | lo, zero past c_f in each half.
int mix_anchor_rows(const void* anchors, int ld, int c_f, const float* w,
                    const int* idx, int K, int taps, void* out, int M,
                    int c_pad, int split, void* stream) {
  if (idx != nullptr || split != 1) return 1010;
  return mix_rows_launch(anchors, ld, c_f, w, nullptr, K, taps, out, M, c_pad,
                         split, stream);
}

// The bf16 route's MLP: x [M, c_in] bf16 the mixed rows (M = R * T; c_in
// = 2 c_pad, hi | lo); w the stream of the head whose every layer reads
// [W_f; W_f] over them (ops/cuda/fused_ray_mlp.py: pack_ray_mlp_params); z
// [M, 1] f32; out [M, 1, out_dim] f32 (= [R, T, out_dim]); taps must be 1.
// The other arguments as fused_ray_mlp_wgmma_forward.
int fused_anchor_mlp_wgmma_forward(const void* x, float* out, const void* w,
                                   const float* bwz, const int* widths,
                                   int n_layers, int c_f, int out_dim,
                                   int last_op, int M, const float* z,
                                   int taps, void* stream) {
  return anchor_launch<true>(x, out, w, bwz, widths, n_layers, c_f, out_dim,
                             last_op, M, z, taps, stream);
}

// The same launch with the math off (out is not touched).
int fused_anchor_mlp_wgmma_stream(const void* x, float* out, const void* w,
                                  const float* bwz, const int* widths,
                                  int n_layers, int c_f, int out_dim,
                                  int last_op, int M, const float* z,
                                  int taps, void* stream) {
  return anchor_launch<false>(x, out, w, bwz, widths, n_layers, c_f, out_dim,
                              last_op, M, z, taps, stream);
}

// The f32 route. feat [R, n_anchors, C_f] f32; wk [R, taps, n_anchors]
// f32; z [R, taps] f32; out [R, taps, out_dim] f32.
int fused_anchor_mlp_forward(const void* feat, const float* wk,
                             const float* z, float* out, float* xp,
                             int xp_rows, const void* wf, const void* wh,
                             const float* wz, const float* b,
                             const int* widths, int n_layers, int out_dim,
                             int last_op, int R, int taps, int n_anchors,
                             void* stream) {
  if (z == nullptr || wk == nullptr) return 1009;
  return mlp_forward(feat, z, wk, out, xp, xp_rows, wf, wh, wz, b, widths,
                     n_layers, out_dim, last_op, R, taps, n_anchors, stream);
}

}  // extern "C"
