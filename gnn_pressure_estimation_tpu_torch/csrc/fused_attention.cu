// Fused dense-mode GAT attention, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_fused_attention in
// gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py (fwd_kernel).
// With M the template's [n, n] adjacency mask (self-loops in) and
// z_ij = a_dst[b,i,h] + a_src[b,j,h] (one f32 add):
//
//   out[b,i,h,:] = sum_j softmax_j(M_ij ? (z_ij >= 0 ? z_ij : slope z_ij)
//                                       : -1e9) v[b,j,h,:]
//
// Layout: a_dst, a_src [B, n, H]; v, out [B, n, H, C] (the layer's own; the
// TPU kernel takes [B, H, n, C] and pads n to 128 lanes).
//
// The TPU kernel forms the whole n x n softmax per (graph, head) and
// multiplies it with V on the MXU. The mask of a water network is about 1%
// dense and every row holds its diagonal, so a masked cell's weight is
// exp(-1e9 - max) = 0 exactly and the sum runs over the row's set cells only.
// That is v2's band attention with one block: nB 1 and BLK = W = n, a_src as
// a_src_win [1, B, n, H], v as x_ext (n_ext = n, no halo), the masked logit
// -1e9 and the same sign test on one f32 add. The mask's MaskIndex
// (ops/graph_attention.py) is the BandIndex of mask[None], so this kernel
// runs v2's row walk (csrc/band_rowwalk.cuh) over its row lists: one warp
// per (b, row) for all heads, the x rows of two entries loaded ahead, the
// weights through shared memory, a running max past 32 entries. Every row
// holds its self-loop, so no row is empty (n_empty = 0): no window-mean pass,
// no mean. The backward (csrc/fused_attention_bwd.cu) runs v2's backward on
// the same band.
//
// bf16 != 0: v2's bf16-operand instance over v stored in bf16 (the dense
// layer's attn_dtype = bfloat16): out = sum bf16(p) v with p the normalised
// weight, Z summed in double and rounded once. The layer rounds out to bf16,
// as its XLA product with a bf16 output does.
//
// Bound: bytes (v read once, out written once; the a's and the index are
// small). Per nonzero the kernel does 2 C flops.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_rowwalk.cuh"

// v: f32, or bf16 when bf16 != 0. vec != 0: C % 4 == 0 and v, out 16-byte
// aligned (the wrapper checks). row_ptr, col: the MaskIndex's row lists.
extern "C" int fused_attention_fwd(const float* a_dst, const float* a_src, const void* v,
                                   const int* row_ptr, const int* col, float* out, int B, int n,
                                   int H, int C, int vec, int bf16, float slope, void* stream) {
  return band_rowwalk<false>(a_dst, a_src, v, row_ptr, col, nullptr, nullptr, out, nullptr,
                             nullptr, B, 1, n, n, H, C, 0, vec, bf16, slope, stream);
}
