// Banded SpMM, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_spmm_flash in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py:
//
//   out[b, blk*BLK + r, :] = sum_j band[blk, r, j] * x_ext[b, blk*BLK + j, :]
//
// with the band stored as int8 edge counts (the factored mean of
// SimpleMeanConv; its 1/deg row scale is applied outside) or as f32 weights.
//
// The band comes compressed: the BandIndex row lists (row_ptr, col) and the
// entries' values as f32, which hold the int8 counts exactly. So an int8 and
// an f32 band go through this one kernel, and the band itself is never read.
//
// Bound: bytes. Each output row gathers ~4 x rows (bigtown; ~3.6 on the
// 23k-node meganet): about 0.5 FLOP a byte in f32. Tensor cores would help
// only as a dense product over the W window, ~200x the useful work, and
// their TF32 inputs would break the 1e-4 gate against the plain version; so
// TMA and wgmma do not apply. What the design buys instead:
// - no wasted scan: one warp per (b, row) loads up to 32 of the row's
//   (col, val) pairs with one coalesced load, one entry a lane, and
//   broadcasts each with __shfl_sync; a row past 32 entries takes more chunks;
// - 16-byte loads: each lane owns 4 consecutive channels of a 128-channel
//   tile and reads them as one float4, so at C 128 a warp moves a whole
//   512-byte x row with one load a lane (a scalar variant serves C % 4 != 0
//   or an unaligned x_ext);
// - several loads in flight: the x rows of kGroup entries are loaded before
//   their FMAs;
// - L2 reuse: the grid is b-major, row-minor, so neighbouring warps take
//   neighbouring RCM rows, whose x rows overlap.
// Each channel sums in list order (ascending j), one fmaf an entry.
//
// The backward is csrc/band_spmm_bwd.cu.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kTile = 128;              // channels per tile: 4 a lane
constexpr int kGroup = 4;               // entries whose x rows load before their FMAs

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
band_spmm_fwd_kernel(const float* __restrict__ x_ext,   // [B, n_ext, C]
                     const int* __restrict__ row_ptr,   // [n_pad + 1]
                     const int* __restrict__ col,       // [nnz]
                     const float* __restrict__ val,     // [nnz]
                     float* __restrict__ out,           // [B, n_pad, C]
                     int B, int nB, int BLK, int W, int C) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  if (warp >= (long long)B * n_pad) return;
  const long long row = warp % n_pad;
  const long long b = warp / n_pad;
  const long long blk = row / BLK;
  const long long n_ext = n_pad + W - BLK;

  const float* xw = x_ext + (b * n_ext + blk * BLK) * C;
  float* orow = out + (b * n_pad + row) * C;
  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];

  for (int c0 = 0; c0 < C; c0 += kTile) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = k0; s0 < k1; s0 += 32) {   // one chunk of the row's list
      const int k = s0 + lane;
      const int jl = k < k1 ? col[k] : 0;
      const float wl = k < k1 ? val[k] : 0.f;
      const int cnt = min(32, k1 - s0);
      for (int g = 0; g < cnt; g += kGroup) {
        float4 xv[kGroup];
        float w[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int s = min(g + q, cnt - 1);   // past the chunk: a valid row, not summed
          w[q] = __shfl_sync(kFull, wl, s);
          xv[q] = load_slot<kVec>(xw + (long long)__shfl_sync(kFull, jl, s) * C,
                                  kVec ? c0 + 4 * lane : c0 + lane, C);
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (g + q < cnt) fma4(w[q], xv[q], acc);
      }
    }
    if (kVec) {
      const int c = c0 + 4 * lane;
      if (c < C) *reinterpret_cast<float4*>(orow + c) = acc;
    } else {
      const int c = c0 + lane;
      if (c < C) orow[c] = acc.x;
      if (c + 32 < C) orow[c + 32] = acc.y;
      if (c + 64 < C) orow[c + 64] = acc.z;
      if (c + 96 < C) orow[c + 96] = acc.w;
    }
  }
}

}  // namespace

// vec != 0: C % 4 == 0 and x_ext, out 16-byte aligned (the wrapper checks).
extern "C" int band_spmm_fwd(const float* x_ext, const int* row_ptr,
                             const int* col, const float* val, float* out,
                             int B, int nB, int BLK, int W, int C, int vec,
                             void* stream) {
  const long long warps = (long long)B * nB * BLK;
  if (warps == 0) return (int)cudaSuccess;
  auto kernel = vec ? band_spmm_fwd_kernel<true> : band_spmm_fwd_kernel<false>;
  kernel<<<blocks_for(warps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      x_ext, row_ptr, col, val, out, B, nB, BLK, W, C);
  return (int)cudaGetLastError();
}
