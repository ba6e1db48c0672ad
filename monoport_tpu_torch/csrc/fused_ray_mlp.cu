// Ray-structured and anchored skip-concat MLPs for Hopper (sm_90a).
//
// fused_ray_mlp_forward replaces the TPU kernel
// monoport_tpu/ops/pallas/fused_ray_mlp.py::_ray_kernel: per ray one feature
// row shared by T z-taps, so W_f feat is computed once per ray and z * w_z is
// a rank-1 term per tap.
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
// reads hit in L1/L2.
//
// Both are bound by operations on the card (see mlp_tiles.cuh, which holds
// the device code and the design). Plain C interface, loaded through ctypes;
// each call launches on the given stream and returns cudaGetLastError().

#include "mlp_tiles.cuh"

extern "C" {

// feat [R, C_f]; z [R, taps] f32; out [R, taps, out_dim] f32. The other
// arguments as mlp_forward (mlp_tiles.cuh).
int fused_ray_mlp_forward(int dtype, const void* feat, const float* z,
                          float* out, float* xp, int xp_rows, const void* wf,
                          const void* wh, const float* wz, const float* b,
                          const int* widths, int n_layers, int out_dim,
                          int last_op, int R, int taps, void* stream) {
  if (z == nullptr) return 1009;
  return mlp_forward(dtype, feat, z, nullptr, out, xp, xp_rows, wf, wh, wz, b,
                     widths, n_layers, out_dim, last_op, R, taps, 1, stream);
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
