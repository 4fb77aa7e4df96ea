// Banded GAT attention over materialised windows, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_band_attention (v1) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel, :99,
// its pallas_call :159). The forward saves nothing but its inputs; the
// softmax is recomputed. With z_j = a_dst[b,i,h] + a_src_win[blk,b,j,h],
// p = softmax_j(LeakyReLU(z_j)) over the set columns of row i and dO the
// cotangent of the forward's output:
//
//   dp_j = dO[b,i,h,:] . x_win[blk,b,j,h,:]
//   dz_j = p_j (dp_j - sum_j p_j dp_j) * (z_j >= 0 ? 1 : slope)
//   d a_dst[b,i,h]         = sum_j dz_j
//   d a_src_win[blk,b,j,h] = sum over the block's rows i of dz_j
//   d x_win[blk,b,j,h,:]   = sum over the block's rows i of p_j dO[b,i,h,:]
//
// The two window cotangents stay in window layout, as the TPU kernel leaves
// them: every cell [blk, b, j] is written exactly once, zero where no row of
// the block has column j set. Folding the overlapping windows back onto the
// node array is left to whoever cut them (autograd of the slicing). A row
// with no set column got a uniform softmax over its W window in the
// forward: it adds dO/W to all W cells of its block's d x_win and nothing to
// the d a's.
//
// Only the x operand and the dx output differ from v2's backward: x_win[blk,
// b, j] in place of x_ext[b, blk*BLK + j], and one dx row per (block,
// column) in place of one per extended row. The weights, the logits' sign
// and the layouts of a_dst, a_src_win and d a_src_win are v2's. So this
// route runs v2's five passes (csrc/band_bwd.cuh) with the columns pass in
// window layout (csrc/band_colwalk.cuh, kWindow): the warp that owns
// extended row e walks the covering blocks in ascending order, each a
// contiguous run of e's entries, loads x_win[blk, b, j] where the run holds
// an entry, and writes d x_win[blk, b, j] once, the zero row (or the block's
// dO/W) included. Its d a_dst and d a_src_win are v2's to the bit when
// x_win is cut from x_ext.
//
// Bound: bytes, most of them the dense d x_win that v1 must write
// ([nB, B, W, H, C], W/BLK times the node array): at bigtown B 32, H*C 256,
// 675 MB, about 0.2 ms at 3.35 TB/s. x_win is read only at the cells some
// row of the block reads, dO once.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_bwd.cuh"

// scratch_p, scratch_dz: [B, nnz, H] f32; scratch_s: [B, nB, H, C] f32, read
// only when n_empty > 0. vec != 0: C % 4 == 0 and x_win, dout 16-byte aligned
// (the wrapper checks). All outputs are written in full.
extern "C" int band_attention_window_bwd(
    const float* a_dst, const float* a_src_win, const float* x_win,
    const float* dout, const int* row_ptr, const int* col, const int* t_ptr,
    const int* t_entry, const int* t_row, const int* empty_ptr,
    const int* empty_row, float* scratch_p, float* scratch_dz,
    float* scratch_s, float* d_a_dst, float* d_a_src_win, float* d_x_win,
    int B, int nB, int BLK, int W, int H, int C, int nnz, int n_empty, int vec,
    float slope, void* stream) {
  return recompute_bwd<true>(a_dst, a_src_win, x_win, dout, row_ptr, col, t_ptr, t_entry, t_row,
                             empty_ptr, empty_row, scratch_p, scratch_dz, scratch_s, d_a_dst,
                             d_a_src_win, d_x_win, B, nB, BLK, W, H, C, nnz, n_empty, vec, slope,
                             (cudaStream_t)stream);
}
