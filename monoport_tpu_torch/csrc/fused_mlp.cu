// Per-point skip-concat MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel monoport_tpu/ops/pallas/fused_mlp.py::_mlp_kernel:
// x [N, C_in] -> [N, out], layer i computing
//     acc_i = x . W_x[i] + b[i] (+ h_{i-1} . W_h[i], i > 0)
// (f(cat[h, x]) = W_h h + W_x x + b), leaky-ReLU 0.01 between layers,
// sigmoid / tanh / none after the last. The whole input row, its z channel
// included, is an operand in the compute type (bf16 or f32), as in the TPU
// kernel; sums are f32 and h is rounded after each activation.
//
// It is the ray MLP's device code (mlp_tiles.cuh) with one tap a point and
// no separate z term: x . [W_x0 | ... | W_x(L-1)] is one GEMM pass over the
// points (xproj_kernel) and the layer loop adds its columns in the epilogue
// (mlp_kernel). C_in pads to a multiple of 32 (257 -> 288, 513 -> 544).
// Bound on the card: operations. The points share nothing, so the scratch
// round trip of x . W_x buys nothing here beyond one code path; folding it
// into the layer GEMMs is the next step for this kernel.
//
// Plain C interface, loaded through ctypes; launches on the given stream
// and returns cudaGetLastError().

#include "mlp_tiles.cuh"

extern "C" {

// x [N, C_in padded]; out [N, out_dim] f32; wf [sum(out_i), C_in padded] the
// W_x^T of every layer; wz [sum(out_i)] zeros. The other arguments as
// mlp_forward (mlp_tiles.cuh).
int fused_mlp_forward(int dtype, const void* x, float* out, float* xp,
                      int xp_rows, const void* wf, const void* wh,
                      const float* wz, const float* b, const int* widths,
                      int n_layers, int out_dim, int last_op, int N,
                      void* stream) {
  return mlp_forward(dtype, x, nullptr, nullptr, out, xp, xp_rows, wf, wh, wz,
                     b, widths, n_layers, out_dim, last_op, N, 1, 1, stream);
}

}  // extern "C"
