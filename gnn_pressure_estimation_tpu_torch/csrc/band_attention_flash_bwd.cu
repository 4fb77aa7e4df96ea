// Banded GAT attention with a streaming softmax, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_band_attention_flash (v4) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel, its
// batch-folded twin and the overlap-add _fold_windows_blocked after it). It
// takes what the forward saved, m and Z [B, n_pad, H], and
// delta[b,i,h] = sum_c dO[b,i,h,c] * O[b,i,h,c] (a reduction made outside, as
// the TPU wrapper does), so every weight is rebuilt on its own,
//
//   p_j  = exp(LeakyReLU(z_j) - m) / Z,   z_j = a_dst[b,i,h] + a_src_win[blk,b,j,h]
//   dp_j = dO[b,i,h,:] . x_ext[b, blk*BLK + j, h, :]
//   dz_j = p_j (dp_j - delta) * (z_j >= 0 ? 1 : slope)
//
// with no row maximum or sum taken again.
//
//   d a_dst[b,i,h]           = sum_j dz_j
//   d a_src_win[blk,b,j,h]   = sum over the block's rows i of dz_j
//   d x_ext[b,blk*BLK+j,h,:] = sum over rows i and over the blocks whose
//                              windows overlap of p_j dO[b,i,h,:]
//
// A row with no set column (m = -1e9, Z = W) adds dO/W to its W window rows
// of d x_ext and nothing to the d a's.
//
// The TPU kernel writes a dense windowed dx and folds it with K shifted
// adds. Here the mask's nonzeros come compressed (BandIndex), regrouped by
// the extended row they read, so the fold is the walk itself. The design is
// v2's backward (csrc/band_attention_bwd.cu), whose columns and cells passes
// it shares (csrc/band_colwalk.cuh); only the weights and rows passes differ,
// since m, Z and delta come given. The passes, per graph b:
//
//   1. weights: one thread per (row, head): p = exp(LeakyReLU(z) - m) / Z of
//               each entry of the row's list, in one loop, written as
//               [B, nnz, H]; in the same launch, 8 warps per (b, 32
//               channels) sum dO/W over each block's rows that have no entry
//               into S [B, nB, H, C] (none when the layout has no such row).
//   2. columns: one warp per extended row e, all heads: d x_ext[e] = sum
//               p dO (+ S of the covering blocks) and dp per (entry, head),
//               from the dO rows of the entries that read e, staged by
//               cp.async as float4 slots.
//   3. rows:    one thread per (row, head): dz = p (dp - delta), the slope
//               where a_dst + a_src < 0, written over dp; d a_dst = sum dz.
//               p is rebuilt from the same loads, in the same order, as in
//               pass 1, so it is the same float.
//   4. cells:   one thread per (extended row e, head): d a_src_win, every
//               cell written once.
//
// A columns pass that rebuilds p itself from a_dst, a_src_win, m and Z (no
// weights pass, no p scratch) was timed beside this one on an H100: 5% slower
// at H*C 256, 9% faster at 128, even over a train step (PERF.md), so the walk
// stays v2's, unchanged.
//
// Bound: bytes (x_ext, dO read once; d x_ext written once; the a's, the
// statistics and the index are small): about 0.5 FLOP a byte. What the design
// does about it is v2's: 16-byte loads (a scalar variant for C % 4 != 0 or an
// unaligned x_ext or dO), several entries' dO rows in flight a warp, a
// register cap for occupancy, b-major grids over RCM-ordered rows for L2
// reuse. No atomics: every sum is taken in a fixed order and a run repeats to
// the bit.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_colwalk.cuh"

namespace {

// p of every entry from the saved statistics: one thread per (b, row, head),
// h fastest, in the first w_blocks thread blocks; the blocks after them sum
// the padded rows' dO into S (empties_block, one per (b, 32 channels)).
__global__ void __launch_bounds__(kThreads)
weights_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
               const float* __restrict__ a_src_win,  // [nB, B, W, H]
               const float* __restrict__ m_in,       // [B, n_pad, H]
               const float* __restrict__ z_in,       // [B, n_pad, H]
               const int* __restrict__ row_ptr,      // [n_pad + 1]
               const int* __restrict__ col,          // [nnz]
               float* __restrict__ p_out,            // [B, nnz, H]
               const float* __restrict__ dout,       // [B, n_pad, H, C]
               const int* __restrict__ empty_ptr,    // [nB + 1]
               const int* __restrict__ empty_row,    // [n_empty]
               float* __restrict__ S,                // [B, nB, H, C]
               int B, int nB, int BLK, int W, int H, int C, int nnz, unsigned w_blocks,
               float slope) {
  if (blockIdx.x >= w_blocks) {          // the whole thread block takes this branch
    const int tiles = (H * C + 31) / 32, q = (int)(blockIdx.x - w_blocks);
    empties_block<kWarps>(dout, empty_ptr, empty_row, S, nB, BLK, W, H * C, q / tiles, q % tiles);
    return;
  }
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_pad = (long long)nB * BLK;
  if (i >= (long long)B * n_pad * H) return;
  const int h = (int)(i % H);
  const long long row = (i / H) % n_pad;
  const long long b = i / H / n_pad;
  const long long blk = row / BLK;
  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];
  const float ad = a_dst[i], m = m_in[i], Z = z_in[i];
  const float* asrc = a_src_win + (blk * B + b) * (long long)W * H + h;
  float* pk = p_out + b * (long long)nnz * H + h;
#pragma unroll 4
  for (int k = k0; k < k1; ++k)
    pk[(long long)k * H] = expf(leaky(ad + __ldg(asrc + (long long)col[k] * H), slope) - m) / Z;
}

// dz over dp and d a_dst: one thread per (b, row, head), h fastest.
__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
            const float* __restrict__ a_src_win,  // [nB, B, W, H]
            const float* __restrict__ m_in,       // [B, n_pad, H]
            const float* __restrict__ z_in,       // [B, n_pad, H]
            const float* __restrict__ delta,      // [B, n_pad, H]
            const int* __restrict__ row_ptr,      // [n_pad + 1]
            const int* __restrict__ col,          // [nnz]
            float* __restrict__ dp_dz,            // [B, nnz, H]: dp in, dz out
            float* __restrict__ d_a_dst,          // [B, n_pad, H]
            int B, int nB, int BLK, int W, int H, int nnz, float slope) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_pad = (long long)nB * BLK;
  if (i >= (long long)B * n_pad * H) return;
  const int h = (int)(i % H);
  const long long row = (i / H) % n_pad;
  const long long b = i / H / n_pad;
  const long long blk = row / BLK;
  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];
  const float ad = a_dst[i], m = m_in[i], Z = z_in[i], dl = delta[i];
  const float* asrc = a_src_win + (blk * B + b) * (long long)W * H + h;
  float* dk = dp_dz + b * (long long)nnz * H + h;
  float dsum = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    const float zpre = ad + __ldg(asrc + (long long)col[k] * H);
    float dz = expf(leaky(zpre, slope) - m) / Z * (dk[(long long)k * H] - dl);
    if (zpre < 0.f) dz *= slope;
    dk[(long long)k * H] = dz;
    dsum += dz;
  }
  d_a_dst[i] = dsum;                     // 0 for a row with no set column
}

}  // namespace

// scratch_p, scratch_dz: [B, nnz, H] f32; scratch_s: [B, nB, H, C] f32, read
// only when n_empty > 0. vec != 0: C % 4 == 0 and x_ext, dout 16-byte aligned
// (the wrapper checks). All outputs are written in full. bf16 != 0: the
// bf16-operand instance, x_ext in bf16 (else f32): its columns pass reads
// the bf16 rows and rounds p and dO to bf16 (csrc/band_colwalk.cuh); the
// weights and rows passes are the f32 ones.
extern "C" int band_attention_flash_bwd(
    const float* a_dst, const float* a_src_win, const void* x_ext,
    const float* m_in, const float* z_in, const float* delta, const float* dout,
    const int* row_ptr, const int* col, const int* t_ptr, const int* t_entry,
    const int* t_row, const int* empty_ptr, const int* empty_row, float* scratch_p,
    float* scratch_dz, float* scratch_s, float* d_a_dst, float* d_a_src_win,
    float* d_x_ext, int B, int nB, int BLK, int W, int H, int C, int nnz,
    int n_empty, int vec, int bf16, float slope, void* stream) {
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if ((long long)B * n_pad * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  if (C == 0) {                          // no channels: dp = delta = 0, so every dz is 0
    cudaError_t err = cudaMemsetAsync(d_a_dst, 0, (size_t)(B * n_pad * H) * sizeof(float), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(d_a_src_win, 0, (size_t)nB * B * W * H * sizeof(float), st);
    return (int)err;
  }
  const unsigned w_blocks = threads_for((long long)B * n_pad * H);
  const unsigned e_blocks = n_empty > 0 ? (unsigned)(B * ((H * C + 31) / 32)) : 0u;
  weights_kernel<<<w_blocks + e_blocks, kThreads, 0, st>>>(
      a_dst, a_src_win, m_in, z_in, row_ptr, col, scratch_p, dout, empty_ptr, empty_row,
      scratch_s, B, nB, BLK, W, H, C, nnz, w_blocks, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const float* S = n_empty > 0 ? scratch_s : nullptr;
  const int rc =
      bf16 ? columns_pass<false, true>(vec, static_cast<const __nv_bfloat16*>(x_ext), dout,
                                       scratch_p, S, t_ptr, t_entry, t_row, empty_ptr, scratch_dz,
                                       d_x_ext, B, nB, BLK, W, H, C, nnz, st)
           : columns_pass<false, false>(vec, static_cast<const float*>(x_ext), dout, scratch_p, S,
                                        t_ptr, t_entry, t_row, empty_ptr, scratch_dz, d_x_ext, B,
                                        nB, BLK, W, H, C, nnz, st);
  if (rc != 0) return rc;
  rows_kernel<<<threads_for((long long)B * n_pad * H), kThreads, 0, st>>>(
      a_dst, a_src_win, m_in, z_in, delta, row_ptr, col, scratch_dz, d_a_dst, B, nB, BLK, W, H,
      nnz, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cells_kernel<<<threads_for((long long)B * n_ext * H), kThreads, 0, st>>>(
      scratch_dz, t_ptr, t_entry, t_row, d_a_src_win, B, nB, BLK, W, H, nnz);
  return (int)cudaGetLastError();
}
