// Banded GAT attention, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_attention_dma (v2) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py. Per destination
// row i of block-row blk = i / BLK, per graph b and head h:
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])   j < W
//   p     = softmax over the j with mask[blk, i % BLK, j] != 0
//   out[b, i, h, :] = sum_j p_j * x_ext[b, blk*BLK + j, h, :]
//
// A row with no set column gets the mean of its W window rows, as the plain
// version does. The walk (one warp per (b, row), all heads; the window-mean
// pre-pass; the bound and what the design does about it) is
// csrc/band_rowwalk.cuh, shared with the flash forward
// (csrc/band_attention_flash.cu), which also writes the row statistics.
//
// The backward is csrc/band_attention_bwd.cu (csrc/band_attention_acc_bwd.cu
// on the "acc" route).
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_rowwalk.cuh"

// vec != 0: C % 4 == 0 and x_ext, out 16-byte aligned (the wrapper checks).
// n_empty: the number of band rows with no set column (mean is then
// [B, nB, H*C] scratch; with none the pre-pass is not launched). bf16 != 0:
// the bf16-operand instance (the TPU kernel's mx = bfloat16) over x_ext
// stored in bf16: out = sum bf16(p) x with p the normalised weight; else
// x_ext is f32.
extern "C" int band_attention_fwd(const float* a_dst, const float* a_src_win,
                                  const void* x_ext, const int* row_ptr,
                                  const int* col, const int* empty_ptr,
                                  float* mean, float* out, int B, int nB,
                                  int BLK, int W, int H, int C, int n_empty,
                                  int vec, int bf16, float slope, void* stream) {
  return band_rowwalk<false>(a_dst, a_src_win, x_ext, row_ptr, col, empty_ptr, mean, out,
                             nullptr, nullptr, B, nB, BLK, W, H, C, n_empty, vec, bf16, slope,
                             stream);
}
