// Banded GAT attention over materialised windows, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_attention (v1) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (fwd_kernel). The
// operands are the window tensors themselves, never an extended node array:
// per destination row i of block-row blk = i / BLK, per graph b and head h,
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])   j < W
//   p     = softmax over the j with mask[blk, i % BLK, j] != 0
//   out[b, i, h, :] = sum_j p_j * x_win[blk, b, j, h, :]
//
// That is the kernel's point: it works where only the windows exist (a
// caller that gathered them itself), at the price of a window tensor W/BLK
// times the node array.
//
// A row with no set column (a padded band row: no self-loop) gets a uniform
// softmax over its W window, as the plain version does: the mean of the
// window's rows.
//
// The TPU kernel holds a [BLK, W] logits tile and an f32 mask per grid cell.
// Here the row's set columns come compressed (BandIndex row lists): one warp
// per (b, row, head) takes the maximum over the row's list, then the sum of
// exp(z - max) x rows with the channels over its lanes, tile by tile of up to 256
// channels, and divides by the sum. 64-bit offsets throughout: a window
// tensor passes 2^31 elements at a 23k-node network.
//
// The backward is csrc/band_attention_window_bwd.cu.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kMaxPerLane = 8;          // channels per lane in one tile, at most

// kPerLane channels per lane in one tile: 4 where C <= 128 (fewer registers,
// more warps in flight), else 8.
template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
band_attention_window_fwd_kernel(
    const float* __restrict__ a_dst,      // [B, n_pad, H]
    const float* __restrict__ a_src_win,  // [nB, B, W, H]
    const float* __restrict__ x_win,      // [nB, B, W, H, C]
    const int* __restrict__ row_ptr,      // [n_pad + 1]
    const int* __restrict__ col,          // [nnz]
    float* __restrict__ out,              // [B, n_pad, H, C]
    int B, int nB, int BLK, int W, int H, int C, float slope) {
  constexpr int kTile = 32 * kPerLane;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  if (warp >= (long long)B * n_pad * H) return;
  const int h = (int)(warp % H);
  const long long row = (warp / H) % n_pad;
  const long long b = warp / H / n_pad;
  const long long blk = row / BLK;
  const long long HC = (long long)H * C;

  const long long win = (blk * B + b) * W;                 // first window cell
  const float* asrc = a_src_win + win * H + h;
  const float* xw = x_win + win * HC + (long long)h * C;
  const float ad = a_dst[(b * n_pad + row) * H + h];
  float* orow = out + (b * n_pad + row) * HC + (long long)h * C;
  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];

  if (k0 == k1) {  // no set column: the mean of the window's rows
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < W; ++j) acc += __ldg(xw + (long long)j * HC + c);
      orow[c] = acc / (float)W;
    }
    return;
  }

  // pass 1: maximum of the LeakyReLU logits over the row's list
  float m = -INFINITY;
  for (int k = k0 + lane; k < k1; k += 32) {
    float z = ad + asrc[(long long)col[k] * H];
    z = z >= 0.f ? z : slope * z;
    m = fmaxf(m, z);
  }
  m = warp_max(m);

  // pass 2: sum of exp(z - m) x over the list, one channel tile at a time
  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
    float Z = 0.f;
    for (int s0 = k0; s0 < k1; s0 += 32) {
      const int k = s0 + lane;
      int j = 0;
      float p = 0.f;
      if (k < k1) {
        j = col[k];
        float z = ad + asrc[(long long)j * H];
        z = z >= 0.f ? z : slope * z;
        p = expf(z - m);
      }
      const int cnt = min(32, k1 - s0);
      for (int s = 0; s < cnt; ++s) {
        const float ps = __shfl_sync(kFull, p, s);
        Z += ps;
        const float* xr = xw + (long long)__shfl_sync(kFull, j, s) * HC + c0;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c0 + c < C) acc[q] = fmaf(ps, __ldg(xr + c), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < C) orow[c0 + c] = acc[q] / Z;
    }
  }
}

}  // namespace

extern "C" int band_attention_window_fwd(
    const float* a_dst, const float* a_src_win, const float* x_win,
    const int* row_ptr, const int* col, float* out, int B, int nB, int BLK,
    int W, int H, int C, float slope, void* stream) {
  const long long warps = (long long)B * nB * BLK * H;
  if (warps == 0) return (int)cudaSuccess;
  auto kernel = C <= 128 ? band_attention_window_fwd_kernel<4>
                         : band_attention_window_fwd_kernel<kMaxPerLane>;
  kernel<<<blocks_for(warps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      a_dst, a_src_win, x_win, row_ptr, col, out, B, nB, BLK, W, H, C, slope);
  return (int)cudaGetLastError();
}
