// Banded GAT attention, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_band_attention_dma (v2) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel and
// the window fold after it): the cotangents of a_dst, a_src_win and x_ext,
// the softmax recomputed, as v2 does (the formulas and the five passes are
// in csrc/band_bwd.cuh, which the v3 and v1 backwards run as well).
//
// The TPU kernel writes a dense [nB, B, W_pad, H*C] window cotangent and
// folds it outside. Here the mask is about 0.5% dense, so the work follows
// its nonzeros, given compressed (BandIndex: by row, and regrouped by the
// extended row they read). No atomics: every output element is written once
// and every sum is taken in a fixed order, so a run repeats to the bit.
//
// Only one pass reads channels, and it gathers one array: the columns pass
// holds x_ext[e] (its own row) and gathers the dO rows of the entries that
// read e, which d x_ext[e] needs anyway, so it takes dp_j there as well. A
// rows pass that took dp would gather every x row a second time (the forward
// gathered them once): at bigtown B 32, H*C 256, some 870 MB more through
// L2.
//
// Bound: bytes (x_ext, dO read once; d x_ext written once; the a's and the
// index are small): about 0.5 FLOP a byte, as in the forward. Tensor cores
// would help only as a dense product over the W window, ~200x the useful
// work, and TF32 would break the 1e-4 gate against the plain version, so
// wgmma and TMA do not apply. What the card rewards here, and the columns
// pass takes: 16-byte loads (float4 slots; a scalar variant for C % 4 != 0
// or an unaligned x_ext or dO), several entries' rows in flight a warp
// (cp.async into shared memory), occupancy kept by a register cap (64 at
// H*C 128: four thread blocks of eight warps an SM; 80 at 256: three), and
// L2 reuse (b-major, row-minor grids over RCM-ordered rows). The scalar
// passes (weights, rows, cells) move nnz*H floats each, a thread per item.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_bwd.cuh"

// scratch_p, scratch_dz: [B, nnz, H] f32; scratch_s: [B, nB, H, C] f32, read
// only when n_empty > 0. vec != 0: C % 4 == 0 and x_ext, dout 16-byte aligned
// (the wrapper checks). All outputs are written in full. bf16 != 0: the
// bf16-operand instance (csrc/band_bwd.cuh), x_ext in bf16; else f32.
extern "C" int band_attention_bwd(
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
