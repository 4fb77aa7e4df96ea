// Banded SpMM, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_band_spmm_flash in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel and
// the window fold after it): with dO the cotangent of the forward's output,
//
//   d x_ext[b, blk*BLK + j, :] = sum over the block's rows r, and over the
//                                blocks whose windows overlap, of
//                                band[blk, r, j] * dO[b, blk*BLK + r, :]
//
// The band (int8 counts or f32 weights) is a constant of the graph and gets
// no cotangent.
//
// The TPU kernel forms the dense [W, BLK] x [BLK, C] product per block into
// a [nB, B, W_pad, C] window cotangent and folds it outside. Here the band
// is about 0.4% dense, so the kernel is a banded SpMM with the transposed
// band, given compressed (BandIndex: the nonzeros grouped by the extended
// row e they read, t_ptr / t_row, and their values in that order, t_val, as
// f32, which holds the int8 counts exactly). It is the forward
// (csrc/band_spmm.cu) in mirror image: it reads dO rows where the forward
// reads x rows, and writes d x_ext rows where the forward writes out rows.
//
// Bound: bytes (dO read once, d x_ext written once): each extended row
// gathers ~4 dO rows, about 0.5 FLOP a byte in f32, so tensor cores and TMA
// do not apply (see csrc/band_spmm.cu). The design, the forward's:
// - no wasted scan: one warp per (b, extended row e) loads up to 32 of e's
//   (t_row, t_val) pairs with one coalesced load, one pair a lane, and
//   broadcasts each by __shfl_sync; an e that more than 32 entries read
//   takes more chunks. No entry index and no value gather per entry;
// - 16-byte loads: each lane owns 4 consecutive channels of a 128-channel
//   tile and reads them as one float4 (a scalar variant serves C % 4 != 0 or
//   an unaligned dO);
// - several loads in flight: the dO rows of kGroup entries are loaded before
//   their FMAs;
// - L2 reuse: the grid is b-major, row-minor over RCM-ordered rows.
// No atomics: every output row is written once, by one warp. Each channel
// sums in t order (ascending band row g), one fmaf an entry from 0, so a
// run repeats to the bit.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kTile = 128;              // channels per tile: 4 a lane
constexpr int kGroup = 4;               // entries whose dO rows load before their FMAs

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
band_spmm_bwd_kernel(const float* __restrict__ dout,    // [B, n_pad, C]
                     const int* __restrict__ t_ptr,     // [n_ext + 1]
                     const int* __restrict__ t_row,     // [nnz]
                     const float* __restrict__ t_val,   // [nnz]
                     float* __restrict__ d_x_ext,       // [B, n_ext, C]
                     int B, int nB, int BLK, int W, int C) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if (warp >= (long long)B * n_ext) return;
  const long long e = warp % n_ext;
  const long long b = warp / n_ext;
  const float* dbase = dout + b * n_pad * C;
  float* xrow = d_x_ext + (b * n_ext + e) * C;
  const int t0 = t_ptr[e], t1 = t_ptr[e + 1];

  for (int c0 = 0; c0 < C; c0 += kTile) {
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int s0 = t0; s0 < t1; s0 += 32) {   // one chunk of the entries that read e
      const int t = s0 + lane;
      const int gl = t < t1 ? t_row[t] : 0;
      const float wl = t < t1 ? t_val[t] : 0.f;
      const int cnt = min(32, t1 - s0);
      for (int g = 0; g < cnt; g += kGroup) {
        float4 dv[kGroup];
        float w[kGroup];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const int s = min(g + q, cnt - 1);   // past the chunk: a valid row, not summed
          w[q] = __shfl_sync(kFull, wl, s);
          dv[q] = load_slot<kVec>(dbase + (long long)__shfl_sync(kFull, gl, s) * C,
                                  kVec ? c0 + 4 * lane : c0 + lane, C);
        }
#pragma unroll
        for (int q = 0; q < kGroup; ++q)
          if (g + q < cnt) fma4(w[q], dv[q], acc);
      }
    }
    if (kVec) {
      const int c = c0 + 4 * lane;
      if (c < C) *reinterpret_cast<float4*>(xrow + c) = acc;
    } else {
      const int c = c0 + lane;
      if (c < C) xrow[c] = acc.x;
      if (c + 32 < C) xrow[c + 32] = acc.y;
      if (c + 64 < C) xrow[c + 64] = acc.z;
      if (c + 96 < C) xrow[c + 96] = acc.w;
    }
  }
}

}  // namespace

// vec != 0: C % 4 == 0 and dout, d_x_ext 16-byte aligned (the wrapper checks).
extern "C" int band_spmm_bwd(const float* dout, const int* t_ptr, const int* t_row,
                             const float* t_val, float* d_x_ext, int B, int nB, int BLK, int W,
                             int C, int vec, void* stream) {
  const long long warps = (long long)B * ((long long)nB * BLK + W - BLK);
  if (warps == 0) return (int)cudaSuccess;
  auto kernel = vec ? band_spmm_bwd_kernel<true> : band_spmm_bwd_kernel<false>;
  kernel<<<blocks_for(warps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      dout, t_ptr, t_row, t_val, d_x_ext, B, nB, BLK, W, C);
  return (int)cudaGetLastError();
}
