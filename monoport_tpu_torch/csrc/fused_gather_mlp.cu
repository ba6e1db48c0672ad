// Ray-structured skip-concat MLP with the bilinear feature gather inside the
// kernel, for Hopper (sm_90a).
//
// Replaces the TPU kernel
// monoport_tpu/ops/pallas/fused_gather_mlp.py::_gather_ray_kernel: a ray's
// feature is the bilinear sample of a [H*W, C] row table,
//     feat[r] = round(sum_k wgt[r, k] * table[idx[r, k]]),  k = 0..3,
// (align_corners=True; a tap outside the image has a clipped index and weight
// exactly 0; rows in the operand type, weights, products and sums f32, one
// rounding to the operand type), and feeds the ray MLP of fused_ray_mlp.cu:
// W_f feat once per ray, z * w_z a rank-1 term per tap. With one tap a ray it
// is a per-point gather + MLP.
//
// The TPU kernel stages the indices through scalar memory, gathers row by row
// in a scalar loop and keeps the whole table in VMEM; none of that carries
// over. Here the gather is the loader of the projection GEMM's A tile
// (gather_xproj_kernel, mlp_tiles.cuh): a block makes its 64 (bf16) or 32
// (f32) feature rows in shared memory, a 16-byte vector a thread from four
// 16-byte loads, and multiplies them by every column of W_f itself, so each
// row is gathered once. The gathered [R, C] rows never reach device memory;
// the table (8 MB in bf16 for the 128 x 128 x 256 map, 16 MB in f32) stays in
// the 50 MB L2 across the rays. The projections take the same f32 scratch
// round trip as in the ray kernel, and mlp_kernel runs unchanged after it.
//
// Bound on the card: operations (the MLP's, as for the ray kernel); the
// bytes are the table rows that the rays touch, the taps, z and the output.
// Plain C interface, loaded through ctypes; launches on the given stream and
// returns cudaGetLastError().

#include "mlp_tiles.cuh"

extern "C" {

// table [H*W, C_f padded] in the operand type; idx [R, 4] i32 rows of the
// table, wgt [R, 4] f32; z [R, taps] f32; out [R, taps, out_dim] f32. The
// other arguments as mlp_forward (mlp_tiles.cuh).
int fused_gather_mlp_forward(int dtype, const void* table, const int* idx,
                             const float* wgt, const float* z, float* out,
                             float* xp, int xp_rows, const void* wf,
                             const void* wh, const float* wz, const float* b,
                             const int* widths, int n_layers, int out_dim,
                             int last_op, int R, int taps, void* stream) {
  if (z == nullptr || idx == nullptr || wgt == nullptr) return 1009;
  return mlp_forward(dtype, table, z, nullptr, out, xp, xp_rows, wf, wh, wz,
                     b, widths, n_layers, out_dim, last_op, R, taps, 1, stream,
                     idx, wgt);
}

}  // extern "C"
