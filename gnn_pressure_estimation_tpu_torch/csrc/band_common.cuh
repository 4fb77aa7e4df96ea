// What the band-attention kernels share: the warp layout, the warp-wide
// reductions, and the pass that every backward runs for band rows with no
// set column. Each .cu is one translation unit, so everything sits in an
// unnamed namespace.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per thread block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// thread blocks of kWarps warps for a grid of one warp per work item
inline unsigned blocks_for(long long warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

// A band row with no set column got the mean of its block's W window rows
// in the forward, so it adds dO/W to every one of them. One warp per
// (b, block, head, 32 channels) sums dO/W over the block's such rows into S;
// a block without any (all but the last, on a real layout) leaves at once
// and its S is not read.
__global__ void __launch_bounds__(kWarps * 32)
empties_kernel(const float* __restrict__ dout,     // [B, n_pad, H, C]
               const int* __restrict__ empty_ptr,  // [nB + 1]
               const int* __restrict__ empty_row,  // [n_empty]
               float* __restrict__ S,              // [B, nB, H, C]
               int B, int nB, int BLK, int W, int H, int C) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int tiles = (C + 31) / 32;
  if (warp >= (long long)B * nB * H * tiles) return;
  const int c = (int)(warp % tiles) * 32 + lane;
  const int h = (int)((warp / tiles) % H);
  const long long blk = (warp / tiles / H) % nB;
  const long long b = warp / tiles / H / nB;
  const int r0 = empty_ptr[blk], r1 = empty_ptr[blk + 1];
  if (r0 == r1 || c >= C) return;
  const long long n_pad = (long long)nB * BLK;
  const long long HC = (long long)H * C;
  const float* dcol = dout + b * n_pad * HC + (long long)h * C + c;
  float acc = 0.f;
  for (int r = r0; r < r1; ++r) acc += dcol[(long long)empty_row[r] * HC];
  S[((b * nB + blk) * H + h) * (long long)C + c] = acc / (float)W;
}

}  // namespace
