// What the band kernels share: the warp layout, the warp-wide reductions,
// the lane's 16-byte (or scalar) slot of an x row, the rounding of the
// bf16-operand instances and their packed quads of a bf16 row, and the pass
// that every attention backward runs for band rows with no set column. Each
// .cu is one translation unit, so everything sits in an unnamed namespace.

#pragma once

#include <cuda_bf16.h>
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

// The softmax denominator of the bf16-operand instances is summed in double
// and rounded once: the weight they round to bf16 is then the same float
// whatever the order of the sum (the plain version's too), where a sum in
// f32 could move it by an ulp and flip its bf16 rounding.
__device__ __forceinline__ double warp_sum_d(double v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

// An operand of the bf16-operand instances (kBf16): rounded to the nearest
// bfloat16, ties to even, as the TPU kernels' astype(bfloat16) rounds it;
// the product of two such values is exact in f32, so only the sums' order
// differs from the MXU's. The f32 instances take it as it is.
template <bool kBf16>
__device__ __forceinline__ float operand(float v) {
  return kBf16 ? __bfloat162float(__float2bfloat16_rn(v)) : v;
}

// kBf16: the first channel of the lane's quad v (kVec: 4 channels of one
// head) or the channel of its element e (scalar) in the tile at c0: the f32
// walks' layout (load_slot's), so bf16 rows take vector_loads' rule.
template <bool kVec>
__device__ __forceinline__ int bf16_channel(int c0, int lane, int v, int e) {
  return kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane + 32 * e;
}

// kBf16: the lane's NV quads of the bf16 row xr, each 4 bf16 packed in a
// uint2 (0 past ce).
template <int NV, bool kVec>
__device__ __forceinline__ void load_bf16_quads(const __nv_bfloat16* __restrict__ xr, int c0,
                                                int lane, int ce, uint2 (&q)[NV]) {
#pragma unroll
  for (int v = 0; v < NV; ++v) {
    if constexpr (kVec) {
      const int c = bf16_channel<true>(c0, lane, v, 0);
      q[v] = c < ce ? __ldg(reinterpret_cast<const uint2*>(xr + c)) : make_uint2(0u, 0u);
    } else {
      unsigned s[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = bf16_channel<false>(c0, lane, v, e);
        s[e] = c < ce ? __bfloat16_as_ushort(__ldg(xr + c)) : 0u;
      }
      q[v] = make_uint2(s[0] | s[1] << 16, s[2] | s[3] << 16);
    }
  }
}

// element e of a packed quad, widened to f32 (exact)
__device__ __forceinline__ float bf16_elem(uint2 q, int e) {
  const unsigned w = e < 2 ? q.x : q.y;
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(e & 1 ? w >> 16 : w & 0xffffu)));
}

// a packed quad widened to f32 (exact): its elements 0-3, as bf16_elem gives them
__device__ __forceinline__ float4 bf16_quad(uint2 q) {
  return make_float4(__uint_as_float(q.x << 16), __uint_as_float(q.x & 0xffff0000u),
                     __uint_as_float(q.y << 16), __uint_as_float(q.y & 0xffff0000u));
}

// four floats rounded to bf16 (to nearest, ties to even), two a conversion,
// packed as a quad in bf16_elem's order
__device__ __forceinline__ uint2 bf16_pack4(float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  return make_uint2(*reinterpret_cast<const unsigned*>(&lo), *reinterpret_cast<const unsigned*>(&hi));
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

// acc += w * x, channel by channel (one fmaf each)
__device__ __forceinline__ void fma4(float w, const float4& x, float4& acc) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

// A band row with no set column got the mean of its block's W window rows
// in the forward, so it adds dO/W to every one of them. One thread block of
// kN warps per (b, 32 channels) finds the blocks that hold such rows (all but
// the last have none on a real layout) and sums dO/W over each one's rows
// into S: its warps take every kN-th row and their partial sums are added in
// warp order, so the chain of dependent loads is kN times shorter than one
// warp's walk. S of the other blocks is not read.
template <int kN>
__device__ __forceinline__ void empties_block(const float* __restrict__ dout,     // [B, n_pad, H*C]
                                              const int* __restrict__ empty_ptr,  // [nB + 1]
                                              const int* __restrict__ empty_row,  // [n_empty]
                                              float* __restrict__ S,              // [B, nB, H*C]
                                              int nB, int BLK, int W, int HC, long long b,
                                              int c_tile) {
  __shared__ float part[kN][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = c_tile * 32 + lane;
  const float* dcol = dout + b * nB * BLK * (long long)HC + c;
  for (int blk = 0; blk < nB; ++blk) {
    const int r0 = empty_ptr[blk], r1 = empty_ptr[blk + 1];
    if (r0 == r1) continue;                        // uniform across the thread block
    float acc = 0.f;
    if (c < HC)
      for (int r = r0 + wid; r < r1; r += kN) acc += dcol[(long long)empty_row[r] * HC];
    part[wid][lane] = acc;
    __syncthreads();
    if (wid == 0 && c < HC) {
      float sum = 0.f;
      for (int w = 0; w < kN; ++w) sum += part[w][lane];
      S[(b * nB + blk) * HC + c] = sum / (float)W;
    }
    __syncthreads();                               // part is read before the next block's sums
  }
}

constexpr int kEmptyWarps = 16;

__global__ void __launch_bounds__(kEmptyWarps * 32)
empties_kernel(const float* __restrict__ dout, const int* __restrict__ empty_ptr,
               const int* __restrict__ empty_row, float* __restrict__ S, int nB, int BLK, int W,
               int HC) {
  empties_block<kEmptyWarps>(dout, empty_ptr, empty_row, S, nB, BLK, W, HC, blockIdx.x, blockIdx.y);
}

// S [B, nB, H, C] for the blocks with padded rows (every backward launches
// this before its columns pass when the layout has such rows).
inline int launch_empties(const float* dout, const int* empty_ptr, const int* empty_row, float* S,
                          int B, int nB, int BLK, int W, int H, int C, cudaStream_t st) {
  empties_kernel<<<dim3((unsigned)B, (unsigned)((H * C + 31) / 32)), kEmptyWarps * 32, 0, st>>>(
      dout, empty_ptr, empty_row, S, nB, BLK, W, H * C);
  return (int)cudaGetLastError();
}

}  // namespace
