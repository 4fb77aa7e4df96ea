// What the band kernels share: the warp layout, the warp-wide reductions,
// the lane's 16-byte (or scalar) slot of an x row, and the pass that every
// attention backward runs for band rows with no set column. Each .cu is one
// translation unit, so everything sits in an unnamed namespace.

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

// The lane's slot of an x row of n floats: channels c .. c+3 as one float4
// (kVec: n % 4 == 0 and a 16-byte aligned row), else c, c+32, c+64, c+96;
// 0 past n.
template <bool kVec>
__device__ __forceinline__ float4 load_slot(const float* __restrict__ xr, int c, int n) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (kVec) {
    if (c < n) v = __ldg(reinterpret_cast<const float4*>(xr + c));
  } else {
    if (c < n) v.x = __ldg(xr + c);
    if (c + 32 < n) v.y = __ldg(xr + c + 32);
    if (c + 64 < n) v.z = __ldg(xr + c + 64);
    if (c + 96 < n) v.w = __ldg(xr + c + 96);
  }
  return v;
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
