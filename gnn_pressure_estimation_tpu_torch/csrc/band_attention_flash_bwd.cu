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
// with no row maximum or sum taken again. That is what lets one pass over
// the extended rows do all the heavy work: an entry's p and dz need nothing
// of the other entries of its row.
//
//   d a_dst[b,i,h]           = sum_j dz_j
//   d a_src_win[blk,b,j,h]   = sum over the block's rows i of dz_j
//   d x_ext[b,blk*BLK+j,h,:] = sum over rows i and over the blocks whose
//                              windows overlap of p_j dO[b,i,h,:]
//
// The TPU kernel writes a dense windowed dx and folds it with K shifted
// adds. Here the mask's nonzeros come compressed (BandIndex), regrouped by
// the extended row they read, so the fold is the walk itself. No atomics:
// every sum is taken in a fixed order and a run repeats to the bit.
//
//   1. empties: one warp per (b, block, head, 32 channels) sums dO/W over the
//               block's rows that have no entry (their forward was the
//               window's mean) into S [B, nB, H, C]; skipped when the layout
//               has none.
//   2. columns: one warp per (b, extended row e, head), channels over lanes.
//               x_ext[e] stays in registers. The lanes first rebuild, one
//               entry each, the weights of the entries that read e (p from m
//               and Z, the LeakyReLU slope, delta); then per entry the warp
//               loads dO of the entry's row once, takes the dot product (dp)
//               and adds p dO to its accumulator; the owning lane forms dz.
//               Writes d x_ext[e] (plus S of the covering blocks) and dz per
//               entry into scratch [B, H, nnz]. C past one tile (256 channels)
//               takes the dot products in the first tile's pass.
//   3. rows and cells: one thread per (b, row, head) sums the row's dz into
//               d a_dst; one thread per window cell (block, b, column, head)
//               sums the dz of the block's entries in that column into
//               d a_src_win, zero where there is none.
//
// Bound: bytes. x_ext read once, dO once per entry (about five per row, from
// L2), d x_ext written once; 4*C flops per nonzero.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kMaxPerLane = 8;          // channels per lane in one tile, at most

// kPerLane channels per lane in one tile: 4 where C <= 128 (fewer registers,
// more warps in flight), else 8.
template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
columns_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
               const float* __restrict__ a_src_win,  // [nB, B, W, H]
               const float* __restrict__ x_ext,      // [B, n_ext, H, C]
               const float* __restrict__ m_in,       // [B, n_pad, H]
               const float* __restrict__ z_in,       // [B, n_pad, H]
               const float* __restrict__ delta,      // [B, n_pad, H]
               const float* __restrict__ dout,       // [B, n_pad, H, C]
               const float* __restrict__ S,          // [B, nB, H, C] or null
               const int* __restrict__ t_ptr,        // [n_ext + 1]
               const int* __restrict__ t_entry,      // [nnz]
               const int* __restrict__ t_row,        // [nnz]
               const int* __restrict__ empty_ptr,    // [nB + 1]
               float* __restrict__ dz_out,           // [B, H, nnz]
               float* __restrict__ d_x_ext,          // [B, n_ext, H, C]
               int B, int nB, int BLK, int W, int H, int C, int nnz,
               float slope) {
  constexpr int kTile = 32 * kPerLane;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int n_pad = nB * BLK;
  const int n_ext = n_pad + W - BLK;
  if (warp >= (long long)B * n_ext * H) return;
  const int h = (int)(warp % H);
  const int e = (int)((warp / H) % n_ext);
  const long long b = warp / H / n_ext;
  const long long HC = (long long)H * C;

  const int t0 = t_ptr[e], t1 = t_ptr[e + 1];
  float* dzk = dz_out + (b * H + h) * (long long)nnz;
  const float* xrow = x_ext + (b * n_ext + e) * HC + (long long)h * C;
  const float* dbase = dout + b * n_pad * HC + (long long)h * C;
  float* dxrow = d_x_ext + (b * n_ext + e) * HC + (long long)h * C;
  const bool one_tile = C <= kTile;

  float xr[kPerLane];
#pragma unroll
  for (int q = 0; q < kPerLane; ++q) {
    const int c = lane + 32 * q;
    xr[q] = (one_tile && c < C) ? __ldg(xrow + c) : 0.f;
  }

  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
    for (int base = t0; base < t1; base += 32) {
      // each lane rebuilds the weight of one entry that reads e, from the
      // saved statistics alone
      const int t = base + lane;
      int g = 0, k = 0;
      float p = 0.f, scale = 0.f, dl = 0.f, dp = 0.f;
      if (t < t1) {
        g = t_row[t];
        k = t_entry[t];
        const int blk = g / BLK;
        const long long stat = (b * n_pad + g) * H + h;
        const float zpre = a_dst[stat] +
            a_src_win[(((long long)blk * B + b) * W + (e - blk * BLK)) * H + h];
        const float z = zpre >= 0.f ? zpre : slope * zpre;
        p = expf(z - m_in[stat]) / z_in[stat];
        scale = zpre >= 0.f ? 1.f : slope;
        dl = delta[stat];
      }
      const int cnt = min(32, t1 - base);
      for (int s = 0; s < cnt; ++s) {
        const float ps = __shfl_sync(kFull, p, s);
        const float* dr = dbase + (long long)__shfl_sync(kFull, g, s) * HC;
        if (c0 == 0) {  // the dot product with x_ext[e], once per entry
          float part = 0.f;
          if (one_tile) {
#pragma unroll
            for (int q = 0; q < kPerLane; ++q) {
              const int c = lane + 32 * q;
              const float dv = c < C ? __ldg(dr + c) : 0.f;
              part = fmaf(dv, xr[q], part);
              acc[q] = fmaf(ps, dv, acc[q]);
            }
          } else {
            for (int c = lane; c < C; c += 32) part = fmaf(__ldg(dr + c), __ldg(xrow + c), part);
          }
          part = warp_sum(part);
          if (lane == s) dp = part;
        }
        if (!one_tile) {
#pragma unroll
          for (int q = 0; q < kPerLane; ++q) {
            const int c = c0 + lane + 32 * q;
            if (c < C) acc[q] = fmaf(ps, __ldg(dr + c), acc[q]);
          }
        }
      }
      if (c0 == 0 && t < t1) dzk[k] = p * (dp - dl) * scale;
    }
    if (S != nullptr) {
      // blocks whose window [blk*BLK, blk*BLK + W) holds e
      const int blk_hi = min(nB - 1, e / BLK);
      const int blk_lo = e >= W ? (e - W) / BLK + 1 : 0;
      for (int blk = blk_lo; blk <= blk_hi; ++blk) {
        if (empty_ptr[blk] == empty_ptr[blk + 1]) continue;
        const float* sr = S + ((b * nB + blk) * H + h) * (long long)C + c0;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c0 + c < C) acc[q] += sr[c];
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < C) dxrow[c0 + c] = acc[q];
    }
  }
}

// d a_dst[b, row, h]: the sum of dz over the row's entries (contiguous in
// row order). One thread each.
__global__ void __launch_bounds__(256)
rows_kernel(const float* __restrict__ dz_in,   // [B, H, nnz]
            const int* __restrict__ row_ptr,   // [n_pad + 1]
            float* __restrict__ d_a_dst,       // [B, n_pad, H]
            int B, int n_pad, int H, int nnz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)B * n_pad * H) return;
  const int h = (int)(i % H);
  const int row = (int)((i / H) % n_pad);
  const long long b = i / H / n_pad;
  const float* dzk = dz_in + (b * H + h) * (long long)nnz;
  float acc = 0.f;
  for (int k = row_ptr[row]; k < row_ptr[row + 1]; ++k) acc += dzk[k];
  d_a_dst[i] = acc;
}

// d a_src_win[blk, b, j, h]: the sum of dz over the entries of extended row
// blk*BLK + j that sit in block blk (a contiguous run of that row's list,
// which is sorted by band row). One thread per cell, every cell written.
__global__ void __launch_bounds__(256)
cells_kernel(const float* __restrict__ dz_in,   // [B, H, nnz]
             const int* __restrict__ t_ptr,     // [n_ext + 1]
             const int* __restrict__ t_entry,   // [nnz]
             const int* __restrict__ t_row,     // [nnz]
             float* __restrict__ d_a_src_win,   // [nB, B, W, H]
             int B, int nB, int BLK, int W, int H, int nnz) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nB * B * W * H) return;
  const int h = (int)(i % H);
  const int j = (int)((i / H) % W);
  const long long b = (i / H / W) % B;
  const int blk = (int)(i / H / W / B);
  const float* dzk = dz_in + (b * H + h) * (long long)nnz;
  const int lo = blk * BLK, hi = lo + BLK;       // the block's band rows
  float acc = 0.f;
  for (int t = t_ptr[lo + j]; t < t_ptr[lo + j + 1]; ++t) {
    const int g = t_row[t];
    if (g >= hi) break;
    if (g >= lo) acc += dzk[t_entry[t]];
  }
  d_a_src_win[i] = acc;
}

}  // namespace

// scratch_dz: [B, H, nnz] f32; scratch_s: [B, nB, H, C] f32, read only when
// n_empty > 0. All outputs are written in full.
extern "C" int band_attention_flash_bwd(
    const float* a_dst, const float* a_src_win, const float* x_ext,
    const float* m_in, const float* z_in, const float* delta,
    const float* dout, const int* row_ptr, const int* t_ptr,
    const int* t_entry, const int* t_row, const int* empty_ptr,
    const int* empty_row, float* scratch_dz, float* scratch_s, float* d_a_dst,
    float* d_a_src_win, float* d_x_ext, int B, int nB, int BLK, int W, int H,
    int C, int nnz, int n_empty, float slope, void* stream) {
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if ((long long)B * n_pad * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (n_empty > 0) {
    empties_kernel<<<blocks_for((long long)B * nB * H * ((C + 31) / 32)),
                     kWarps * 32, 0, st>>>(
        dout, empty_ptr, empty_row, scratch_s, B, nB, BLK, W, H, C);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  auto columns = C <= 128 ? columns_kernel<4> : columns_kernel<kMaxPerLane>;
  columns<<<blocks_for((long long)B * n_ext * H), kWarps * 32, 0, st>>>(
      a_dst, a_src_win, x_ext, m_in, z_in, delta, dout,
      n_empty > 0 ? scratch_s : nullptr, t_ptr, t_entry, t_row, empty_ptr,
      scratch_dz, d_x_ext, B, nB, BLK, W, H, C, nnz, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * n_pad * H;
  rows_kernel<<<(unsigned)((rows + 255) / 256), 256, 0, st>>>(
      scratch_dz, row_ptr, d_a_dst, B, (int)n_pad, H, nnz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = (long long)nB * B * W * H;
  cells_kernel<<<(unsigned)((cells + 255) / 256), 256, 0, st>>>(
      scratch_dz, t_ptr, t_entry, t_row, d_a_src_win, B, nB, BLK, W, H, nnz);
  return (int)cudaGetLastError();
}
