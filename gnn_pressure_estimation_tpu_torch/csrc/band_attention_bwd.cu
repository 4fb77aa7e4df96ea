// Banded GAT attention, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_band_attention_dma (v2) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel and
// the window fold after it). With z_j = a_dst[b,i,h] + a_src_win[blk,b,j,h],
// p = softmax_j(LeakyReLU(z_j)) over the set columns of row i (recomputed, as
// v2 does: the forward saves nothing but its inputs) and dO the cotangent of
// the forward's output:
//
//   dp_j    = dO[b,i,h,:] . x_ext[b, blk*BLK + j, h, :]
//   dz_j    = p_j (dp_j - sum_j p_j dp_j) * (z_j >= 0 ? 1 : slope)
//   d a_dst[b,i,h]          = sum_j dz_j
//   d a_src_win[blk,b,j,h]  = sum over the block's rows i of dz_j
//   d x_ext[b,blk*BLK+j,h,:] = sum over rows i and over the blocks whose
//                              windows overlap of p_j dO[b,i,h,:]
//
// The sign is that of the pre-activation z_j, not of LeakyReLU(z_j). A row
// with no set column got a uniform softmax over its W window in the
// forward: it adds dO/W to all W window rows of d x_ext and nothing to the
// d a's (the mask zeroes the logits' gradient).
//
// The TPU kernel writes a dense [nB, B, W_pad, H*C] window cotangent and
// folds it outside. Here the mask is about 0.5% dense, so the work follows
// its nonzeros, given compressed (BandIndex: by row, and regrouped by the
// extended row they read). Three kernels, no atomics, so the sums are taken
// in a fixed order and a run repeats to the bit:
//
//   1. rows:    one warp per (b, row, head). Lanes own the row's entries:
//               max, exp and sum; then per entry a warp-wide dot product
//               over C for dp; then dz. Writes p and dz per entry into
//               scratch ([B, H, nnz] each) and d a_dst.
//   2. empties: one warp per (b, block, head, 32 channels) sums dO/W over
//               the block's rows that have no entry into S [B, nB, H, C]
//               (skipped when the layout has none).
//   3. columns: one warp per (b, extended row e, head) walks the entries
//               that read e, channels over lanes: d x_ext = sum p dO, plus
//               S of every block whose window holds e; and, block by block,
//               d a_src_win = sum dz. Every output element is written once.
//
// Bound: bytes (x_ext, dO read once; d x_ext written once; the a's and the
// index are small); the dot products and the weighted sums are 4*C flops per
// nonzero, far below the f32 rate at that traffic.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kPerLane = 8;             // channels per lane in one tile
constexpr int kTile = 32 * kPerLane;    // channels per tile

__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
            const float* __restrict__ a_src_win,  // [nB, B, W, H]
            const float* __restrict__ x_ext,      // [B, n_ext, H, C]
            const float* __restrict__ dout,       // [B, n_pad, H, C]
            const int* __restrict__ row_ptr,      // [n_pad + 1]
            const int* __restrict__ col,          // [nnz]
            float* __restrict__ p_out,            // [B, H, nnz]
            float* __restrict__ dz_out,           // [B, H, nnz]
            float* __restrict__ d_a_dst,          // [B, n_pad, H]
            int B, int nB, int BLK, int W, int H, int C, int nnz,
            float slope) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  if (warp >= (long long)B * n_pad * H) return;
  const int h = (int)(warp % H);
  const long long row = (warp / H) % n_pad;
  const long long b = warp / H / n_pad;
  const long long blk = row / BLK;
  const long long n_ext = n_pad + W - BLK;
  const long long HC = (long long)H * C;

  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];
  float* dad = d_a_dst + (b * n_pad + row) * H + h;
  if (k0 == k1) {  // no set column: uniform softmax, no gradient to the a's
    if (lane == 0) *dad = 0.f;
    return;
  }
  const float* asrc = a_src_win + (blk * B + b) * W * H + h;
  const float ad = a_dst[(b * n_pad + row) * H + h];
  const float* xw = x_ext + (b * n_ext + blk * BLK) * HC + (long long)h * C;
  const float* drow = dout + (b * n_pad + row) * HC + (long long)h * C;
  float* pk = p_out + (b * H + h) * (long long)nnz;
  float* dzk = dz_out + (b * H + h) * (long long)nnz;

  // pass 1: max of the LeakyReLU logits over the row's entries
  float m = -INFINITY;
  for (int k = k0 + lane; k < k1; k += 32) {
    float z = ad + asrc[(long long)col[k] * H];
    z = z >= 0.f ? z : slope * z;
    m = fmaxf(m, z);
  }
  m = warp_max(m);

  // pass 2: e_k = exp(z_k - m), dp_k = dO . x_k; the lane that owns entry k
  // keeps both in the scratch rows (it reads them back itself in pass 3)
  float Z = 0.f, num = 0.f;
  for (int c0 = k0; c0 < k1; c0 += 32) {
    const int k = c0 + lane;
    int j = 0;
    float e = 0.f;
    if (k < k1) {
      j = col[k];
      float z = ad + asrc[(long long)j * H];
      z = z >= 0.f ? z : slope * z;
      e = expf(z - m);
    }
    float dp = 0.f;
    const int cnt = min(32, k1 - c0);
    for (int s = 0; s < cnt; ++s) {
      const int js = __shfl_sync(kFull, j, s);
      const float* xr = xw + (long long)js * HC;
      float part = 0.f;
      for (int c = lane; c < C; c += 32) part = fmaf(drow[c], __ldg(xr + c), part);
      part = warp_sum(part);
      if (lane == s) dp = part;
    }
    if (k < k1) {
      Z += e;
      num = fmaf(e, dp, num);
      pk[k] = e;
      dzk[k] = dp;
    }
  }
  Z = warp_sum(Z);
  const float delta = warp_sum(num) / Z;

  // pass 3: p_k = e_k / Z, dz_k = p_k (dp_k - delta), slope where z_k < 0
  float dsum = 0.f;
  for (int k = k0 + lane; k < k1; k += 32) {
    const float p = pk[k] / Z;
    float dz = p * (dzk[k] - delta);
    if (ad + asrc[(long long)col[k] * H] < 0.f) dz *= slope;
    pk[k] = p;
    dzk[k] = dz;
    dsum += dz;
  }
  dsum = warp_sum(dsum);
  if (lane == 0) *dad = dsum;
}

__global__ void __launch_bounds__(kWarps * 32)
columns_kernel(const float* __restrict__ dout,      // [B, n_pad, H, C]
               const float* __restrict__ p_in,      // [B, H, nnz]
               const float* __restrict__ dz_in,     // [B, H, nnz]
               const float* __restrict__ S,         // [B, nB, H, C] or null
               const int* __restrict__ t_ptr,       // [n_ext + 1]
               const int* __restrict__ t_entry,     // [nnz]
               const int* __restrict__ t_row,       // [nnz]
               const int* __restrict__ empty_ptr,   // [nB + 1]
               float* __restrict__ d_a_src_win,     // [nB, B, W, H]
               float* __restrict__ d_x_ext,         // [B, n_ext, H, C]
               int B, int nB, int BLK, int W, int H, int C, int nnz) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if (warp >= (long long)B * n_ext * H) return;
  const int h = (int)(warp % H);
  const long long e = (warp / H) % n_ext;
  const long long b = warp / H / n_ext;
  const long long HC = (long long)H * C;

  const int t0 = t_ptr[e], t1 = t_ptr[e + 1];
  const float* pk = p_in + (b * H + h) * (long long)nnz;
  const float* dzk = dz_in + (b * H + h) * (long long)nnz;
  // blocks whose window [blk*BLK, blk*BLK + W) holds e
  const int blk_hi = (int)min((long long)nB - 1, e / BLK);
  const int blk_lo = e >= W ? (int)((e - W) / BLK + 1) : 0;

  // d a_src_win[blk, b, e - blk*BLK, h] = sum of dz over the block's entries
  // (sorted by row, so each block's entries are contiguous); every lane
  // takes the same walk, lane 0 writes
  {
    int t = t0;
    for (int blk = blk_lo; blk <= blk_hi; ++blk) {
      float acc = 0.f;
      while (t < t1 && t_row[t] / BLK == blk) acc += dzk[t_entry[t++]];
      if (lane == 0) {
        const long long j = e - (long long)blk * BLK;
        d_a_src_win[(((long long)blk * B + b) * W + j) * H + h] = acc;
      }
    }
  }

  // d x_ext[b, e, h, :] = sum p_k dO[row_k] (+ S of the covering blocks)
  const float* dbase = dout + b * n_pad * HC + (long long)h * C;
  float* xrow = d_x_ext + (b * n_ext + e) * HC + (long long)h * C;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float p = pk[t_entry[t]];
      const float* dr = dbase + (long long)t_row[t] * HC + c0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c0 + c < C) acc[k] = fmaf(p, __ldg(dr + c), acc[k]);
      }
    }
    if (S != nullptr) {
      for (int blk = blk_lo; blk <= blk_hi; ++blk) {
        if (empty_ptr[blk] == empty_ptr[blk + 1]) continue;
        const float* sr = S + ((b * nB + blk) * H + h) * (long long)C + c0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int c = lane + 32 * k;
          if (c0 + c < C) acc[k] += sr[c];
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c0 + c < C) xrow[c0 + c] = acc[k];
    }
  }
}

}  // namespace

// scratch_p, scratch_dz: [B, H, nnz] f32; scratch_s: [B, nB, H, C] f32, read
// only when n_empty > 0. All outputs are written in full.
extern "C" int band_attention_bwd(
    const float* a_dst, const float* a_src_win, const float* x_ext,
    const float* dout, const int* row_ptr, const int* col, const int* t_ptr,
    const int* t_entry, const int* t_row, const int* empty_ptr,
    const int* empty_row, float* scratch_p, float* scratch_dz,
    float* scratch_s, float* d_a_dst, float* d_a_src_win, float* d_x_ext,
    int B, int nB, int BLK, int W, int H, int C, int nnz, int n_empty,
    float slope, void* stream) {
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if ((long long)B * n_pad * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  rows_kernel<<<blocks_for((long long)B * n_pad * H), kWarps * 32, 0, st>>>(
      a_dst, a_src_win, x_ext, dout, row_ptr, col, scratch_p, scratch_dz,
      d_a_dst, B, nB, BLK, W, H, C, nnz, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_empty > 0) {
    empties_kernel<<<blocks_for((long long)B * nB * H * ((C + 31) / 32)),
                     kWarps * 32, 0, st>>>(
        dout, empty_ptr, empty_row, scratch_s, B, nB, BLK, W, H, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  columns_kernel<<<blocks_for((long long)B * n_ext * H), kWarps * 32, 0, st>>>(
      dout, scratch_p, scratch_dz, n_empty > 0 ? scratch_s : nullptr, t_ptr,
      t_entry, t_row, empty_ptr, d_a_src_win, d_x_ext, B, nB, BLK, W, H, C,
      nnz);
  return (int)cudaGetLastError();
}
