// Ray-structured skip-concat MLP with the bilinear feature gather, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel
// monoport_tpu/ops/pallas/fused_gather_mlp.py::_gather_ray_kernel: a ray's
// feature is the bilinear sample of a [H*W, C] row table,
//     feat[r] = round(sum_k wgt[r, k] * table[idx[r, k]]),  k = 0..3,
// (align_corners=True; a tap outside the image has a clipped index and weight
// exactly 0; rows in the operand type, weights, products and sums f32, one
// rounding to the operand type), and feeds the ray MLP of fused_ray_mlp.cu:
// W_f feat, z * w_z a rank-1 term per tap. With one tap a ray it is a
// per-point gather + MLP. The TPU kernel stages the indices through scalar
// memory, gathers row by row in a scalar loop and keeps the whole table in
// VMEM; none of that carries over. Two dtypes, two routes:
//  * bf16: mix_gather_rows (mix_rows.cuh, bound by bytes) writes each ray's
//    combined feature row [R, C_f] bf16, the four taps in the TPU kernel's
//    order and its one rounding (no new rounding point), and the ray MLP's
//    wgmma kernel (fused_ray_mlp.cu, RayEpilogue, the T taps of a ray in T
//    blocks) runs on them: two launches, the table (8 MB in bf16 for the
//    128 x 128 x 256 map) and the rows in L2. The route it replaced (the
//    gather as the loader of an mma.sync projection pass into an f32
//    scratch, then mma.sync layers) took 3.6x as long at 36,864 rays x 6
//    taps on an H100 (PERF.md).
//  * f32 (fused_gather_mlp_forward): the parity route, mlp_tiles.cuh's
//    gather_xproj_kernel: a block makes its 32 feature rows in shared
//    memory, a 16-byte vector a thread from four 16-byte loads, and
//    multiplies them by every column of W_f into the f32 scratch; mlp_kernel
//    runs after it.
//
// Bound on the card: operations (the MLP's, as for the ray kernel); the
// mix pass alone by the bytes of the table rows the rays touch, the taps
// and its output. Plain C interface, loaded through ctypes; launches on the
// given stream and returns cudaGetLastError(), or 1000 + code for a bad
// argument.

#include "mix_rows.cuh"
#include "mlp_tiles.cuh"

extern "C" {

// The bf16 route's pass. table [H*W, ld] bf16 (c_f columns used); wgt [R, 4]
// f32 and idx [R, 4] i32 rows of the table (J = 4, taps = 1, split 0); out
// [R, c_pad] bf16, zero past c_f.
int mix_gather_rows(const void* table, int ld, int c_f, const float* wgt,
                    const int* idx, int J, int taps, void* out, int R,
                    int c_pad, int split, void* stream) {
  if (idx == nullptr) return 1009;
  if (J != 4 || taps != 1 || split != 0) return 1010;
  return mix_rows_launch(table, ld, c_f, wgt, idx, J, taps, out, R, c_pad,
                         split, stream);
}

// The f32 route. table [H*W, C_f padded] f32; idx [R, 4] i32 rows of the
// table, wgt [R, 4] f32; z [R, taps] f32; out [R, taps, out_dim] f32. The
// other arguments as mlp_forward (mlp_tiles.cuh).
int fused_gather_mlp_forward(const void* table, const int* idx,
                             const float* wgt, const float* z, float* out,
                             float* xp, int xp_rows, const void* wf,
                             const void* wh, const float* wz, const float* b,
                             const int* widths, int n_layers, int out_dim,
                             int last_op, int R, int taps, void* stream) {
  if (z == nullptr || idx == nullptr || wgt == nullptr) return 1009;
  return mlp_forward(table, z, nullptr, out, xp, xp_rows, wf, wh, wz, b,
                     widths, n_layers, out_dim, last_op, R, taps, 1, stream,
                     idx, wgt);
}

}  // extern "C"
