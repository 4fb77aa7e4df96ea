// Fused factored aggregation of dense-mode GAT, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_fused_factored in
// gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py (fwd_kernel).
// With M the template's [n, n] adjacency mask (self-loops in) and the 0/1
// gate P_ij = M_ij [a_dst[b,i,h] + a_src[b,j,h] >= 0] (one f32 add, >=):
//
//   t_pv[b,i,h,:] = sum_j P_ij rhs_v[b,j,h,:]
//   t_nq[b,i,h,:] = sum_j (M_ij - P_ij) rhs_q[b,j,h,:]
//
// Layout: a_dst, a_src [B, n, H]; rhs_v, rhs_q, t_pv, t_nq [B, n, H, D] (the
// layer's own; the TPU kernel takes [B, H, n, D] and pads n to 128 lanes).
// D = C + 1 is odd (a ones column carries the softmax denominator).
//
// The TPU kernel forms the n x n gate tile and two MXU products per (graph,
// head). The mask of a water network is about 1% dense, so each set cell
// goes to exactly one of the two sums, and this kernel walks each row's list
// of set cells (MaskIndex: row_ptr, col) instead: one warp per (b, i) for
// all heads, the list in chunks of 32 entries with their gate bits formed a
// lane an entry, the rows of rhs_v or rhs_q of several entries loaded ahead
// of their adds. The gate is never stored. That walk, its bound (bytes:
// rhs_v and rhs_q read once between them per set cell's row, both outputs
// written once; ~4 us at synthctown B 32, H 2, D 33 on an H100 SXM) and why
// it is latency that sets its time are in csrc/dense_walk.cuh, which the
// backward (csrc/fused_factored_bwd.cu) runs over the column lists.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "dense_walk.cuh"

extern "C" int fused_factored_fwd(const float* a_dst, const float* a_src,
                                  const float* rhs_v, const float* rhs_q,
                                  const int* row_ptr, const int* col,
                                  float* t_pv, float* t_nq, int B, int n,
                                  int H, int D, void* stream) {
  return dense_walk(DenseWalk{a_dst, a_src, rhs_v, rhs_q, row_ptr, col, t_pv, t_nq, B, n, H, D},
                    stream);
}
