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
//  * f32 (fused_ray_mlp_forward, dtype 0): the parity route on plain FMA,
//    mlp_tiles.cuh (an xproj pass into a bounded f32 scratch, then the layer
//    kernel). wgmma has no f32 operands, and TF32 would break the 2e-5
//    parity with the f32 reference.
//
// fused_anchor_mlp_forward replaces
// monoport_tpu/ops/pallas/fused_ray_mlp.py::_anchor_kernel: per ray K anchor
// feature rows; each tap mixes their projections with its K hat weights,
//     acc_i = sum_k w[r, t, k] * (feat[r, k] . W_f[i]) + z * w_z[i] + b[i]
//             (+ h . W_h[i]).
// The TPU kernel's (tiles, taps) grid, its 8-lane mix tensor and its
// per-layer scratch answer a scoped-VMEM limit and have no counterpart here:
// the K projections of a ray are K rows of the same xproj pass, and the
// layer epilogue mixes them in f32 from the block's K weights a row, held in
// shared memory. The T taps of a ray sit in one block, so the K rows it
// reads hit in L1/L2. It runs mlp_tiles.cuh in both dtypes.
//
// All are bound by operations on paper (see the headers). Plain C
// interface, loaded through ctypes; each call launches on the given stream
// and returns cudaGetLastError().

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

}  // namespace

extern "C" {

// The f32 route (dtype must be 0). feat [R, C_f]; z [R, taps] f32; out
// [R, taps, out_dim] f32. The other arguments as mlp_forward (mlp_tiles.cuh).
int fused_ray_mlp_forward(int dtype, const void* feat, const float* z,
                          float* out, float* xp, int xp_rows, const void* wf,
                          const void* wh, const float* wz, const float* b,
                          const int* widths, int n_layers, int out_dim,
                          int last_op, int R, int taps, void* stream) {
  if (z == nullptr) return 1009;
  if (dtype != 0) return 1005;
  return mlp_forward(dtype, feat, z, nullptr, out, xp, xp_rows, wf, wh, wz, b,
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

// feat [R, n_anchors, C_f]; wk [R, taps, n_anchors] f32; z [R, taps] f32;
// out [R, taps, out_dim] f32.
int fused_anchor_mlp_forward(int dtype, const void* feat, const float* wk,
                             const float* z, float* out, float* xp,
                             int xp_rows, const void* wf, const void* wh,
                             const float* wz, const float* b,
                             const int* widths, int n_layers, int out_dim,
                             int last_op, int R, int taps, int n_anchors,
                             void* stream) {
  if (z == nullptr || wk == nullptr) return 1009;
  return mlp_forward(dtype, feat, z, wk, out, xp, xp_rows, wf, wh, wz, b,
                     widths, n_layers, out_dim, last_op, R, taps, n_anchors,
                     stream);
}

}  // extern "C"
