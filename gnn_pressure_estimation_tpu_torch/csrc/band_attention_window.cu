// Banded GAT attention over materialised windows, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_attention (v1) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (fwd_kernel). The
// operands are the window tensors themselves, never an extended node array:
// per destination row i of block-row blk = i / BLK, per graph b and head h,
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])   j < W
//   p     = softmax over the j with mask[blk, i % BLK, j] != 0
//   out[b, i, h, :] = sum_j p_j * x_win[blk, b, j, h, :]
//
// That is the kernel's point: it works where only the windows exist (a
// caller that gathered them itself), at the price of a window tensor W/BLK
// times the node array.
//
// A row with no set column (a padded band row: no self-loop) gets a uniform
// softmax over its W window, as the plain version does: the mean of the
// window's rows.
//
// This is v2's function with x read in window layout: x_win[blk, b, j] where
// v2 reads x_ext[b, blk*BLK + j]. So the route runs v2's row walk
// (csrc/band_rowwalk.cuh, kWindow: one warp per (b, row) for all heads, the
// row list in chunks of 32, x rows loaded ahead of the softmax, the padded
// rows' window mean from a pre-pass once a block; its note gives the bound and
// what the design does about it). On an x_win cut from x_ext its output
// equals v2's bit for bit. Unlike v2, every block reads its own copy of the
// window: neighbouring blocks' rows do not share x rows through L2.
//
// The backward is csrc/band_attention_window_bwd.cu.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_rowwalk.cuh"

// vec != 0: C % 4 == 0 and x_win, out 16-byte aligned (the wrapper checks).
// n_empty: the number of band rows with no set column (mean is then
// [B, nB, H*C] scratch; with none the pre-pass is not launched).
// logit != 0: the logits rounded as a layer with bf16 activations rounds them
// (logit_of<true>), the weights and the product in f32, as the v1 kernel of
// the JAX package computes them for that layer.
extern "C" int band_attention_window_fwd(
    const float* a_dst, const float* a_src_win, const float* x_win,
    const int* row_ptr, const int* col, const int* empty_ptr, float* mean,
    float* out, int B, int nB, int BLK, int W, int H, int C, int n_empty,
    int vec, int logit, float slope, void* stream) {
  return band_rowwalk<false, true>(a_dst, a_src_win, x_win, row_ptr, col, empty_ptr, mean, out,
                                   nullptr, nullptr, B, nB, BLK, W, H, C, n_empty, vec,
                                   logit ? 2 : 0, slope, stream);
}
