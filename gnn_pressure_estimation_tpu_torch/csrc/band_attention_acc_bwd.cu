// Banded GAT attention, backward of the sliding-accumulator route, for
// Hopper (sm_90a).
//
// Replaces the backward of make_band_attention_acc (v3) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel,
// :1420, its pallas_call :1551). The forward is v2's (csrc/band_attention.cu),
// as v3 reuses it, and so are the gradients: v3 differs from v2 only in how
// the TPU kernel writes d x_ext.
//
// What carries over from the TPU kernel. v3 absorbs window i into a
// [W_pad, H*C] VMEM accumulator, flushes the BLK rows that are final and
// slides by BLK: each row of d x_ext is summed whole and written once onto
// the extended array, with no windowed [nB, B, W, H*C] tensor and no fold.
// That carry needs the grid to run in order, which a GPU grid does not. On
// this card the accumulator becomes the owner warp of the column walk
// (csrc/band_colwalk.cuh): one warp per extended row e sums d x_ext[e] over
// the entries of every block whose window holds e, in registers, and writes
// it once, with no windowed tensor, no fold and no atomics. That is the
// columns pass of v2's backward, so this route runs v2's five passes
// (csrc/band_bwd.cuh) and its outputs are v2's to the bit.
//
// Bound: bytes, as v2's backward (x_ext, dO read once; d x_ext written
// once; the a's and the index are small).
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_bwd.cuh"

// scratch_p, scratch_dz: [B, nnz, H] f32; scratch_s: [B, nB, H, C] f32, read
// only when n_empty > 0. vec != 0: C % 4 == 0 and x_ext, dout 16-byte aligned
// (the wrapper checks). All outputs are written in full. bf16 != 0: the
// bf16-operand instance (csrc/band_bwd.cuh), x_ext in bf16; else f32.
extern "C" int band_attention_acc_bwd(
    const float* a_dst, const float* a_src_win, const void* x_ext,
    const float* dout, const int* row_ptr, const int* col, const int* t_ptr,
    const int* t_entry, const int* t_row, const int* empty_ptr,
    const int* empty_row, float* scratch_p, float* scratch_dz,
    float* scratch_s, float* d_a_dst, float* d_a_src_win, float* d_x_ext,
    int B, int nB, int BLK, int W, int H, int C, int nnz, int n_empty, int vec,
    int bf16, float slope, void* stream) {
  if (bf16)
    return recompute_bwd<false, true>(
        a_dst, a_src_win, static_cast<const __nv_bfloat16*>(x_ext), dout, row_ptr, col, t_ptr,
        t_entry, t_row, empty_ptr, empty_row, scratch_p, scratch_dz, scratch_s, d_a_dst,
        d_a_src_win, d_x_ext, B, nB, BLK, W, H, C, nnz, n_empty, vec, slope, (cudaStream_t)stream);
  return recompute_bwd<false, false>(
      a_dst, a_src_win, static_cast<const float*>(x_ext), dout, row_ptr, col, t_ptr, t_entry,
      t_row, empty_ptr, empty_row, scratch_p, scratch_dz, scratch_s, d_a_dst, d_a_src_win,
      d_x_ext, B, nB, BLK, W, H, C, nnz, n_empty, vec, slope, (cudaStream_t)stream);
}
