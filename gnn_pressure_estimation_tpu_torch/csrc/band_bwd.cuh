// The backward that recomputes the softmax, as three band-attention routes
// run it: v2 (csrc/band_attention_bwd.cu), v3 (csrc/band_attention_acc_bwd.cu,
// the same function) and v1 (csrc/band_attention_window_bwd.cu, x and d x in
// window layout); and the dense softmax backward (csrc/fused_attention_bwd.cu),
// v2's function on a band of one block (nB 1, BLK = W = n). With
// z_j = a_dst[b,i,h] + a_src_win[blk,b,j,h],
// p = softmax_j(LeakyReLU(z_j)) over the set columns of row i (recomputed:
// the forward saves nothing but its inputs) and dO the cotangent of the
// forward's output:
//
//   dp_j    = dO[b,i,h,:] . x_ext[b, blk*BLK + j, h, :]   (v1: x_win[blk,b,j,h,:])
//   dz_j    = p_j (dp_j - sum_j p_j dp_j) * (z_j >= 0 ? 1 : slope)
//   d a_dst[b,i,h]          = sum_j dz_j
//   d a_src_win[blk,b,j,h]  = sum over the block's rows i of dz_j
//   d x_ext[b,blk*BLK+j,h,:] = sum over rows i and over the blocks whose
//                              windows overlap of p_j dO[b,i,h,:]
//                              (v1: d x_win[blk,b,j,h,:], the block's rows only)
//
// The sign is that of the pre-activation z_j, not of LeakyReLU(z_j). A row
// with no set column got a uniform softmax over its W window in the
// forward: it adds dO/W to all W window rows of d x and nothing to the
// d a's (the mask zeroes the logits' gradient).
//
// The passes, per graph b, over the mask's BandIndex (by row, and regrouped
// by the extended row the entries read):
//
//   1. weights: one thread per (row, head): the row's logits from its list
//               (col, a_src_win), a running max and sum, then p per entry,
//               written as [B, nnz, H].
//   2. empties: in the same launch, 8 warps per (b, 32 channels) sum dO/W
//               over each block's rows that have no entry into S [B, nB, H, C]
//               (csrc/band_common.cuh; none when the layout has no such row).
//   3. columns: one warp per extended row e, all heads: d x[e] = sum p dO
//               (+ S of each covering block that holds padded rows) and dp of
//               each (entry, head), from the dO rows of the entries that read
//               e, staged by cp.async (csrc/band_colwalk.cuh, shared with the
//               v4 backward; in window layout one run of entries, one x_win
//               row and one d x_win row per covering block).
//   4. rows:    one thread per (row, head): delta = sum p dp over the row's
//               list, dz = p (dp - delta), the slope where a_dst + a_src < 0,
//               written over dp; d a_dst = sum dz.
//   5. cells:   one thread per (extended row e, head): d a_src_win, every
//               cell written once (csrc/band_colwalk.cuh).
//
// The three routes compute the same dp, p and dz from the same values in the
// same order, so their d a_dst and d a_src_win agree to the bit when x_win is
// cut from x_ext.
//
// kBf16 (v2, v3 and the dense softmax; v1 has no such instance): the
// bf16-operand backward of the TPU kernels' mx = bfloat16, and of the dense
// layer's attn_dtype = bfloat16. The weights pass takes the row's max, then
// Z summed in double and rounded once, then p = exp(z - m) / Z: the p the
// bf16 forward rounded, and the same float whatever the order of the sum.
// The columns pass reads x_ext stored in bf16, the rows the bf16 forward
// gathered, and rounds p and dO to bf16 (d x = sum bf16(p) bf16(dO), dp =
// bf16(dO) . x); the rows pass takes delta and dz from the f32 p, as the TPU
// kernel does. The dense instance (kRoundDp) also rounds dp to bf16 there, as
// the XLA product of the dense layer rounds its output; that layer rounds d x
// itself. No atomics: every output element is written once and every
// sum is taken in a fixed order, so a run repeats to the bit.

#pragma once

#include "band_colwalk.cuh"

namespace {

constexpr float kRunningMaxInit = -3e38f;

// p of every entry: one thread per (b, row, head), h fastest, in the first
// w_blocks thread blocks; the blocks after them sum the padded rows' dO into
// S (empties_block, one per (b, 32 channels)): the two are independent, so
// one launch overlaps them. kBf16: m first, then Z in double (above).
template <bool kBf16, bool kLogit = false>
__global__ void __launch_bounds__(kThreads)
weights_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
               const float* __restrict__ a_src_win,  // [nB, B, W, H]
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
  const float ad = a_dst[i];
  const float* asrc = a_src_win + (blk * B + b) * (long long)W * H + h;
  float m = kRunningMaxInit, Z = 0.f;
  if constexpr (kLogit) {                // as kBf16, the logits rounded (logit_of)
    static_assert(kBf16, "the logit rounding has the bf16-operand instance only");
    for (int k = k0; k < k1; ++k)
      m = fmaxf(m, logit_of<true>(ad + __ldg(asrc + (long long)col[k] * H), slope));
    double zs = 0.0;
    for (int k = k0; k < k1; ++k)
      zs += (double)expf(logit_of<true>(ad + __ldg(asrc + (long long)col[k] * H), slope) - m);
    Z = (float)zs;
    float* pk = p_out + b * (long long)nnz * H + h;
    for (int k = k0; k < k1; ++k)
      pk[(long long)k * H] =
          expf(logit_of<true>(ad + __ldg(asrc + (long long)col[k] * H), slope) - m) / Z;
    return;
  } else if (kBf16) {
    for (int k = k0; k < k1; ++k) m = fmaxf(m, leaky(ad + __ldg(asrc + (long long)col[k] * H), slope));
    double zs = 0.0;
    for (int k = k0; k < k1; ++k)
      zs += (double)expf(leaky(ad + __ldg(asrc + (long long)col[k] * H), slope) - m);
    Z = (float)zs;
  } else {
#pragma unroll 4
    for (int k = k0; k < k1; ++k) {
      const float z = leaky(ad + __ldg(asrc + (long long)col[k] * H), slope);
      const float m_new = fmaxf(m, z);
      Z = Z * expf(m - m_new) + expf(z - m_new);
      m = m_new;
    }
  }
  float* pk = p_out + b * (long long)nnz * H + h;
#pragma unroll 4
  for (int k = k0; k < k1; ++k)
    pk[(long long)k * H] = expf(leaky(ad + __ldg(asrc + (long long)col[k] * H), slope) - m) / Z;
}

// dz over dp and d a_dst: one thread per (b, row, head), h fastest.
// kRoundDp: dp is rounded to bf16 as it is read, before delta and dz (the
// dense softmax's bf16 instance: the XLA product that gives dp there has a
// bf16 output); a kernel of its own, so rows_kernel's code stays as it was. kLogit
// (with kRoundDp: rows_logit_kernel): the XLA backward of a layer with bf16
// activations rounds the logits' cotangent p (dp - delta) to bf16, then the
// negative branch's product with the (rounded) slope, as it rounds the
// cotangent of each bf16 op.
template <bool kRoundDp, bool kLogit = false>
__device__ __forceinline__ void rows_body(const float* __restrict__ a_dst,
                                          const float* __restrict__ a_src_win,
                                          const int* __restrict__ row_ptr,
                                          const int* __restrict__ col,
                                          const float* __restrict__ p_in,
                                          float* __restrict__ dp_dz, float* __restrict__ d_a_dst,
                                          int B, int nB, int BLK, int W, int H, int nnz,
                                          float slope) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_pad = (long long)nB * BLK;
  if (i >= (long long)B * n_pad * H) return;
  const int h = (int)(i % H);
  const long long row = (i / H) % n_pad;
  const long long b = i / H / n_pad;
  const long long blk = row / BLK;
  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];
  const float* pk = p_in + b * (long long)nnz * H + h;
  float* dk = dp_dz + b * (long long)nnz * H + h;
  float delta = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k)
    delta = fmaf(pk[(long long)k * H], operand<kRoundDp>(dk[(long long)k * H]), delta);
  const float ad = a_dst[i];
  const float* asrc = a_src_win + (blk * B + b) * (long long)W * H + h;
  float dsum = 0.f;
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float dz = pk[(long long)k * H] * (operand<kRoundDp>(dk[(long long)k * H]) - delta);
    if constexpr (kLogit) {
      dz = operand<true>(dz);
      if (ad + __ldg(asrc + (long long)col[k] * H) < 0.f) dz = operand<true>(slope * dz);
    } else {
      if (ad + __ldg(asrc + (long long)col[k] * H) < 0.f) dz *= slope;
    }
    dk[(long long)k * H] = dz;
    dsum += dz;
  }
  d_a_dst[i] = dsum;                     // 0 for a row with no set column
}

__global__ void __launch_bounds__(kThreads)
rows_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
            const float* __restrict__ a_src_win,  // [nB, B, W, H]
            const int* __restrict__ row_ptr,      // [n_pad + 1]
            const int* __restrict__ col,          // [nnz]
            const float* __restrict__ p_in,       // [B, nnz, H]
            float* __restrict__ dp_dz,            // [B, nnz, H]: dp in, dz out
            float* __restrict__ d_a_dst,          // [B, n_pad, H]
            int B, int nB, int BLK, int W, int H, int nnz, float slope) {
  rows_body<false>(a_dst, a_src_win, row_ptr, col, p_in, dp_dz, d_a_dst, B, nB, BLK, W, H, nnz,
                   slope);
}

__global__ void __launch_bounds__(kThreads)
rows_round_dp_kernel(const float* __restrict__ a_dst, const float* __restrict__ a_src_win,
                     const int* __restrict__ row_ptr, const int* __restrict__ col,
                     const float* __restrict__ p_in, float* __restrict__ dp_dz,
                     float* __restrict__ d_a_dst, int B, int nB, int BLK, int W, int H, int nnz,
                     float slope) {
  rows_body<true>(a_dst, a_src_win, row_ptr, col, p_in, dp_dz, d_a_dst, B, nB, BLK, W, H, nnz,
                  slope);
}

__global__ void __launch_bounds__(kThreads)
rows_logit_kernel(const float* __restrict__ a_dst, const float* __restrict__ a_src_win,
                  const int* __restrict__ row_ptr, const int* __restrict__ col,
                  const float* __restrict__ p_in, float* __restrict__ dp_dz,
                  float* __restrict__ d_a_dst, int B, int nB, int BLK, int W, int H, int nnz,
                  float slope) {
  rows_body<true, true>(a_dst, a_src_win, row_ptr, col, p_in, dp_dz, d_a_dst, B, nB, BLK, W, H,
                        nnz, slope);
}

// The five passes on the stream. scratch_p, scratch_dz: [B, nnz, H] f32;
// scratch_s: [B, nB, H, C] f32, read only when n_empty > 0. vec != 0: C % 4
// == 0 and x, dout 16-byte aligned (the wrapper checks). x and d_x: x_ext
// and d x_ext [B, n_ext, H, C], or with kWindow x_win and d x_win
// [nB, B, W, H, C]. All outputs are written in full. kBf16: the
// bf16-operand instance, x_ext in bf16. kRoundDp: the rows pass rounds dp to
// bf16 (rows_round_dp_kernel; only the dense softmax's bf16 instance).
// kLogit (with kBf16 and kRoundDp): the logits and their cotangents rounded
// as a layer with bf16 activations rounds them (weights_kernel<true, true>,
// rows_logit_kernel).
template <bool kWindow = false, bool kBf16 = false, bool kRoundDp = false, bool kLogit = false>
int recompute_bwd(const float* a_dst, const float* a_src_win, const typename XRow<kBf16>::T* x,
                  const float* dout, const int* row_ptr, const int* col, const int* t_ptr,
                  const int* t_entry, const int* t_row, const int* empty_ptr, const int* empty_row,
                  float* scratch_p, float* scratch_dz, float* scratch_s, float* d_a_dst,
                  float* d_a_src_win, float* d_x, int B, int nB, int BLK, int W, int H, int C,
                  int nnz, int n_empty, int vec, float slope, cudaStream_t st) {
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if ((long long)B * n_pad * H == 0) return (int)cudaSuccess;
  if (C == 0) {                          // no channels: dp = 0, so every dz is 0
    cudaError_t err = cudaMemsetAsync(d_a_dst, 0, (size_t)(B * n_pad * H) * sizeof(float), st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(d_a_src_win, 0, (size_t)nB * B * W * H * sizeof(float), st);
    return (int)err;
  }
  const unsigned w_blocks = threads_for((long long)B * n_pad * H);
  const unsigned e_blocks = n_empty > 0 ? (unsigned)(B * ((H * C + 31) / 32)) : 0u;
  static_assert(!kLogit || (kBf16 && kRoundDp), "kLogit goes with kBf16 and kRoundDp");
  weights_kernel<kBf16, kLogit><<<w_blocks + e_blocks, kThreads, 0, st>>>(
      a_dst, a_src_win, row_ptr, col, scratch_p, dout, empty_ptr, empty_row, scratch_s, B, nB,
      BLK, W, H, C, nnz, w_blocks, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int rc = columns_pass<kWindow, kBf16>(vec, x, dout, scratch_p, n_empty > 0 ? scratch_s : nullptr,
                                       t_ptr, t_entry, t_row, empty_ptr, scratch_dz, d_x, B, nB,
                                       BLK, W, H, C, nnz, st);
  if (rc != 0) return rc;
  (kLogit ? rows_logit_kernel : kRoundDp ? rows_round_dp_kernel : rows_kernel)<<<threads_for((long long)B * n_pad * H),
                                                     kThreads, 0, st>>>(
      a_dst, a_src_win, row_ptr, col, scratch_p, scratch_dz, d_a_dst, B, nB, BLK, W, H, nnz,
      slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  cells_kernel<<<threads_for((long long)B * n_ext * H), kThreads, 0, st>>>(
      scratch_dz, t_ptr, t_entry, t_row, d_a_src_win, B, nB, BLK, W, H, nnz);
  return (int)cudaGetLastError();
}

}  // namespace
