// Banded GAT attention over materialised windows, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_band_attention (v1) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel). The
// forward saves nothing but its inputs; the softmax is recomputed. With
// z_j = a_dst[b,i,h] + a_src_win[blk,b,j,h], p = softmax_j(LeakyReLU(z_j))
// over the set columns of row i and dO the cotangent of the forward's output:
//
//   dp_j = dO[b,i,h,:] . x_win[blk,b,j,h,:]
//   dz_j = p_j (dp_j - sum_j p_j dp_j) * (z_j >= 0 ? 1 : slope)
//   d a_dst[b,i,h]         = sum_j dz_j
//   d a_src_win[blk,b,j,h] = sum over the block's rows i of dz_j
//   d x_win[blk,b,j,h,:]   = sum over the block's rows i of p_j dO[b,i,h,:]
//
// The two window cotangents stay in window layout, as the TPU kernel leaves
// them: every cell [blk, b, j, h] is written exactly once, zero where no row
// of the block has column j set. Folding the overlapping windows back onto
// the node array is left to whoever cut them (autograd of the slicing).
// The sign is that of the pre-activation z_j. A row with no set column got a
// uniform softmax over its W window in the forward: it adds dO/W to all W
// cells of its block's d x_win and nothing to the d a's.
//
// The mask's nonzeros come compressed (BandIndex: by row, and regrouped by
// extended row e = blk*BLK + j, which within one block is the window column).
// Three kernels, no atomics, so a run repeats to the bit:
//
//   1. rows:    one warp per (b, row, head): max, exp and sum over the row's
//               list, per entry a warp-wide dot product over C, then p and dz
//               per entry into scratch ([B, H, nnz] each) and d a_dst.
//   2. empties: one warp per (b, block, head, 32 channels) sums dO/W over the
//               block's rows that have no entry into S [B, nB, H, C] (skipped
//               when the layout has none).
//   3. cells:   one warp per (block, b, window column j, head) walks the
//               entries of extended row blk*BLK + j that belong to the block,
//               channels over lanes: d x_win = sum p dO (+ S of the block),
//               d a_src_win = sum dz.
//
// Bound: bytes, and most of them the dense d x_win that v1 must write
// ([nB, B, W, H, C], W/BLK times the node array).
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kMaxPerLane = 8;          // channels per lane in one tile, at most

__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
            const float* __restrict__ a_src_win,  // [nB, B, W, H]
            const float* __restrict__ x_win,      // [nB, B, W, H, C]
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
  const long long HC = (long long)H * C;

  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];
  float* dad = d_a_dst + (b * n_pad + row) * H + h;
  if (k0 == k1) {  // no set column: uniform softmax, no gradient to the a's
    if (lane == 0) *dad = 0.f;
    return;
  }
  const long long win = (blk * B + b) * W;
  const float* asrc = a_src_win + win * H + h;
  const float* xw = x_win + win * HC + (long long)h * C;
  const float ad = a_dst[(b * n_pad + row) * H + h];
  const float* drow = dout + (b * n_pad + row) * HC + (long long)h * C;
  float* pk = p_out + (b * H + h) * (long long)nnz;
  float* dzk = dz_out + (b * H + h) * (long long)nnz;

  float m = -INFINITY;
  for (int k = k0 + lane; k < k1; k += 32) {
    float z = ad + asrc[(long long)col[k] * H];
    z = z >= 0.f ? z : slope * z;
    m = fmaxf(m, z);
  }
  m = warp_max(m);

  // e_k = exp(z_k - m) and dp_k = dO . x_k; the lane that owns entry k keeps
  // both in the scratch rows and reads them back itself below
  float Z = 0.f, num = 0.f;
  for (int s0 = k0; s0 < k1; s0 += 32) {
    const int k = s0 + lane;
    int j = 0;
    float e = 0.f;
    if (k < k1) {
      j = col[k];
      float z = ad + asrc[(long long)j * H];
      z = z >= 0.f ? z : slope * z;
      e = expf(z - m);
    }
    float dp = 0.f;
    const int cnt = min(32, k1 - s0);
    for (int s = 0; s < cnt; ++s) {
      const float* xr = xw + (long long)__shfl_sync(kFull, j, s) * HC;
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

// kPerLane channels per lane in one tile: 4 where C <= 128 (fewer registers,
// more warps in flight), else 8.
template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
cells_kernel(const float* __restrict__ dout,      // [B, n_pad, H, C]
             const float* __restrict__ p_in,      // [B, H, nnz]
             const float* __restrict__ dz_in,     // [B, H, nnz]
             const float* __restrict__ S,         // [B, nB, H, C] or null
             const int* __restrict__ t_ptr,       // [n_ext + 1]
             const int* __restrict__ t_entry,     // [nnz]
             const int* __restrict__ t_row,       // [nnz]
             const int* __restrict__ empty_ptr,   // [nB + 1]
             float* __restrict__ d_a_src_win,     // [nB, B, W, H]
             float* __restrict__ d_x_win,         // [nB, B, W, H, C]
             int B, int nB, int BLK, int W, int H, int C, int nnz) {
  constexpr int kTile = 32 * kPerLane;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)nB * B * W * H) return;      // warp = the cell's index
  const int h = (int)(warp % H);
  const long long j = (warp / H) % W;
  const long long b = (warp / H / W) % B;
  const long long blk = warp / H / W / B;
  const long long n_pad = (long long)nB * BLK;
  const long long HC = (long long)H * C;

  // the entries of extended row e that sit in block blk: a contiguous run
  const long long e = blk * BLK + j;
  int t0 = t_ptr[e];
  const int t_end = t_ptr[e + 1];
  while (t0 < t_end && t_row[t0] / BLK < blk) ++t0;
  int t1 = t0;
  while (t1 < t_end && t_row[t1] / BLK == blk) ++t1;

  const float* pk = p_in + (b * H + h) * (long long)nnz;
  const float* dzk = dz_in + (b * H + h) * (long long)nnz;
  float dsum = 0.f;
  for (int t = t0; t < t1; ++t) dsum += dzk[t_entry[t]];
  if (lane == 0) d_a_src_win[warp] = dsum;

  const bool spread = S != nullptr && empty_ptr[blk] != empty_ptr[blk + 1];
  const float* dbase = dout + b * n_pad * HC + (long long)h * C;
  float* cell = d_x_win + warp * C;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float p = pk[t_entry[t]];
      const float* dr = dbase + (long long)t_row[t] * HC + c0;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int c = lane + 32 * q;
        if (c0 + c < C) acc[q] = fmaf(p, __ldg(dr + c), acc[q]);
      }
    }
    if (spread) {
      const float* sr = S + ((b * nB + blk) * H + h) * (long long)C + c0;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int c = lane + 32 * q;
        if (c0 + c < C) acc[q] += sr[c];
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < C) cell[c0 + c] = acc[q];
    }
  }
}

}  // namespace

// scratch_p, scratch_dz: [B, H, nnz] f32; scratch_s: [B, nB, H, C] f32, read
// only when n_empty > 0. All outputs are written in full.
extern "C" int band_attention_window_bwd(
    const float* a_dst, const float* a_src_win, const float* x_win,
    const float* dout, const int* row_ptr, const int* col, const int* t_ptr,
    const int* t_entry, const int* t_row, const int* empty_ptr,
    const int* empty_row, float* scratch_p, float* scratch_dz,
    float* scratch_s, float* d_a_dst, float* d_a_src_win, float* d_x_win,
    int B, int nB, int BLK, int W, int H, int C, int nnz, int n_empty,
    float slope, void* stream) {
  const long long n_pad = (long long)nB * BLK;
  if ((long long)B * n_pad * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  rows_kernel<<<blocks_for((long long)B * n_pad * H), kWarps * 32, 0, st>>>(
      a_dst, a_src_win, x_win, dout, row_ptr, col, scratch_p, scratch_dz,
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
  auto cells = C <= 128 ? cells_kernel<4> : cells_kernel<kMaxPerLane>;
  cells<<<blocks_for((long long)nB * B * W * H), kWarps * 32, 0, st>>>(
      dout, scratch_p, scratch_dz, n_empty > 0 ? scratch_s : nullptr, t_ptr,
      t_entry, t_row, empty_ptr, d_a_src_win, d_x_win, B, nB, BLK, W, H, C,
      nnz);
  return (int)cudaGetLastError();
}
