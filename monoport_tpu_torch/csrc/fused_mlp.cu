// Per-point skip-concat MLP for Hopper (sm_90a).
//
// Replaces the TPU kernel monoport_tpu/ops/pallas/fused_mlp.py::_mlp_kernel:
// x [N, C_in] -> [N, out], layer i computing
//     acc_i = [h_{i-1} | x] . [W_h[i]; W_x[i]] + b[i],  acc_0 = x W_x[0] + b[0]
// (f(cat[h, x]) = W_h h + W_x x + b), leaky-ReLU 0.01 between layers,
// sigmoid / tanh / none after the last. The whole input row, its z channel
// included, is an operand in the compute type, as in the TPU kernel; sums
// and the bias are f32 and h is rounded after each activation.
//
// Two dtypes, two routes; the C entry points say which.
//
// bf16 (fused_mlp_wgmma_forward): one pass, one launch, no scratch: the
// wgmma kernel of wgmma_mlp.cuh (design, shared-memory budget and bound
// there) with PointEpilogue, the bias alone. A block owns 64 points.
// Bound: operations on paper (netG: 2.5 MFLOP a point, 0.627 ms at 262,144
// points at 989 TFLOP/s), but every 64-point block streams all the packed
// weights from L2 (2.5 MB for netG, 11.2 GB at 262,144 points with the x
// tiles): L2 bandwidth is the floor of this tiling. fused_mlp_wgmma_stream
// runs the same ring with no math and measures it (PERF.md).
//
// f32 (fused_mlp_forward): the parity route, kept on plain FMA in
// the shared device code (mlp_tiles.cuh: an xproj pass into an f32 scratch,
// then the layer kernel). wgmma has no f32 operands, and TF32 would break
// the 2e-5 parity with the f32 reference.
//
// Plain C interface, loaded through ctypes; launches on the given stream
// and returns cudaGetLastError().

#include "wgmma_mlp.cuh"

namespace {

template <bool Math>
int point_launch(const void* x, float* out, const void* w, const float* bias,
                 const int* widths, int n_layers, int c_in, int out_dim,
                 int last_op, int n_pts, void* stream) {
  WgmmaDims d;
  const int bad = wgmma_dims(&d, widths, n_layers, c_in, out_dim, last_op);
  if (bad) return bad;
  if (n_pts < 1) return 1002;
  const PointEpilogue epi{bias, out, n_pts};
  return wgmma_launch<PointEpilogue, Math>(x, n_pts, w, epi,
                                           (n_pts + kBM - 1) / kBM, d, stream);
}

}  // namespace

extern "C" {

// The f32 route. x [N, C_in padded] f32; out [N, out_dim] f32; wf [sum(out_i),
// C_in padded] the W_x^T of every layer; wz [sum(out_i)] zeros. The other
// arguments as mlp_forward (mlp_tiles.cuh). bf16 takes
// fused_mlp_wgmma_forward.
int fused_mlp_forward(const void* x, float* out, float* xp, int xp_rows,
                      const void* wf, const void* wh, const float* wz,
                      const float* b, const int* widths, int n_layers,
                      int out_dim, int last_op, int N, void* stream) {
  return mlp_forward(x, nullptr, nullptr, out, xp, xp_rows, wf, wh, wz, b,
                     widths, n_layers, out_dim, last_op, N, 1, 1, stream);
}

// The bf16 route. x [N, c_in] bf16 (c_in a multiple of 32); w the packed
// weight stream (ops/cuda/wgmma.py: tile_stream); bias [sum(widths)]
// f32; widths the n_layers kernel widths; out [N, out_dim] f32. Returns a
// cudaError_t, or 1000 + code for a bad argument.
int fused_mlp_wgmma_forward(const void* x, float* out, const void* w,
                            const float* bias, const int* widths,
                            int n_layers, int c_in, int out_dim, int last_op,
                            int N, void* stream) {
  return point_launch<true>(x, out, w, bias, widths, n_layers, c_in, out_dim,
                            last_op, N, stream);
}

// The same launch with the math off: the ring streams every weight and x
// tile and nothing is computed or written (out is not touched).
int fused_mlp_wgmma_stream(const void* x, float* out, const void* w,
                           const float* bias, const int* widths, int n_layers,
                           int c_in, int out_dim, int last_op, int N,
                           void* stream) {
  return point_launch<false>(x, out, w, bias, widths, n_layers, c_in,
                             out_dim, last_op, N, stream);
}

}  // extern "C"
