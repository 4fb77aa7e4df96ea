// Fused factored aggregation of dense-mode GAT, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_fused_factored in
// gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py (bwd_kernel).
// With the 0/1 gate P_ij = M_ij [a_dst[b,i,h] + a_src[b,j,h] >= 0]
// (recomputed: one f32 add, >=) and g_pv, g_nq the cotangents of the
// forward's two outputs:
//
//   d rhs_v[b,j,h,:] = sum_i P_ij g_pv[b,i,h,:]
//   d rhs_q[b,j,h,:] = sum_i (M_ij - P_ij) g_nq[b,i,h,:]
//
// The gate is a comparison: a_dst and a_src get no cotangent.
//
// Both sums scatter by column. The kernel walks the transposed index instead
// (MaskIndex: the set cells sorted by column, with their rows, t_ptr and
// t_row): the forward's walk (csrc/dense_walk.cuh) with one warp per (b, j)
// for all heads, its own gate term a_src[b, j] and the listed rows' a_dst,
// reading one row of g_pv or of g_nq per set cell and writing each output
// row once. No atomics, so a run repeats to the bit. The mask need not be
// symmetric.
//
// Bound: bytes (g_pv and g_nq read once between them per set cell's row,
// both outputs written once), as the forward's; see csrc/dense_walk.cuh.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "dense_walk.cuh"

extern "C" int fused_factored_bwd(const float* a_dst, const float* a_src,
                                  const float* g_pv, const float* g_nq,
                                  const int* t_ptr, const int* t_row,
                                  float* d_rv, float* d_rq, int B, int n,
                                  int H, int D, void* stream) {
  return dense_walk(DenseWalk{a_src, a_dst, g_pv, g_nq, t_ptr, t_row, d_rv, d_rq, B, n, H, D},
                    stream);
}
