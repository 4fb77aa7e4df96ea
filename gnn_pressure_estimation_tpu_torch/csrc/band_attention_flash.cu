// Banded GAT attention with a streaming softmax, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_attention_flash (v4) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (fwd_kernel and
// its batch-folded twin: the same function on another grid). Per destination
// row i of block-row blk = i / BLK, per graph b and head h:
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])   j < W
//   m     = max of z_j over the set columns of mask row i
//   Z     = sum of exp(z_j - m) over them
//   out[b, i, h, :] = sum_j exp(z_j - m) / Z * x_ext[b, blk*BLK + j, h, :]
//
// and it returns m and Z [B, n_pad, H] beside out: the backward
// (csrc/band_attention_flash_bwd.cu) rebuilds each weight from them and never
// takes a row maximum or sum again. A row with no set column gets the mean of
// its W window rows, m = -1e9 (the masked logit) and Z = W.
//
// What makes it the streaming kernel: the row's state is O(1) in W. The TPU
// kernel streams dense W-chunks of the window and the mask; here the mask is
// a fraction of a percent dense at the sizes this kernel is for (W 1920 on a
// 23k-node network), so the row's set columns come compressed (BandIndex row
// lists) and are streamed 32 at a time, with a running max and sum per head.
// That is the walk of v2's forward (csrc/band_rowwalk.cuh: one warp per
// (b, row) for all heads, float4 slots, x rows loaded ahead of the softmax,
// the padded rows' window mean from a pre-pass once a block; its note gives
// the bound and what the design does about it), instantiated to write m and
// Z from the same walk that writes out.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_rowwalk.cuh"

// vec != 0: C % 4 == 0 and x_ext, out 16-byte aligned (the wrapper checks).
// n_empty: the number of band rows with no set column (mean is then
// [B, nB, H*C] scratch; with none the pre-pass is not launched). bf16 != 0:
// the bf16-operand instance (the TPU kernel's mx = bfloat16) over x_ext
// stored in bf16: out = sum bf16(exp(z - m)) x / Z, Z the sum of the
// unrounded numerators; else x_ext is f32.
extern "C" int band_attention_flash_fwd(
    const float* a_dst, const float* a_src_win, const void* x_ext,
    const int* row_ptr, const int* col, const int* empty_ptr, float* mean,
    float* out, float* m_out, float* z_out, int B, int nB, int BLK, int W,
    int H, int C, int n_empty, int vec, int bf16, float slope, void* stream) {
  return band_rowwalk<true>(a_dst, a_src_win, x_ext, row_ptr, col, empty_ptr, mean, out,
                            m_out, z_out, B, nB, BLK, W, H, C, n_empty, vec, bf16, slope,
                            stream);
}
