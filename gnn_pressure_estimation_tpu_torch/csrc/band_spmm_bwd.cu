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
// row they read, values as f32, which holds the int8 counts exactly). One
// warp per (b, extended row e) walks the entries that read e with the
// channels spread over its lanes. No atomics: every output row is written
// once, by one warp, in a fixed order.
//
// Bound: bytes (dO read once, d x_ext written once).
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per thread block
constexpr int kPerLane = 8;             // channels per lane in one tile
constexpr int kTile = 32 * kPerLane;    // channels per tile

__global__ void __launch_bounds__(kWarps * 32)
band_spmm_bwd_kernel(const float* __restrict__ dout,    // [B, n_pad, C]
                     const float* __restrict__ val,     // [nnz]
                     const int* __restrict__ t_ptr,     // [n_ext + 1]
                     const int* __restrict__ t_entry,   // [nnz]
                     const int* __restrict__ t_row,     // [nnz]
                     float* __restrict__ d_x_ext,       // [B, n_ext, C]
                     int B, long long n_pad, long long n_ext, int C) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * n_ext) return;
  const long long e = warp % n_ext;
  const long long b = warp / n_ext;
  const int t0 = t_ptr[e], t1 = t_ptr[e + 1];
  const float* dbase = dout + b * n_pad * C;
  float* xrow = d_x_ext + (b * n_ext + e) * C;

  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float w = val[t_entry[t]];
      const float* dr = dbase + (long long)t_row[t] * C + c0;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        const int c = lane + 32 * k;
        if (c0 + c < C) acc[k] = fmaf(w, __ldg(dr + c), acc[k]);
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

extern "C" int band_spmm_bwd(const float* dout, const float* val,
                             const int* t_ptr, const int* t_entry,
                             const int* t_row, float* d_x_ext, int B, int nB,
                             int BLK, int W, int C, void* stream) {
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  const long long warps = (long long)B * n_ext;
  if (warps == 0) return (int)cudaSuccess;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  band_spmm_bwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                         (cudaStream_t)stream>>>(dout, val, t_ptr, t_entry,
                                                 t_row, d_x_ext, B, n_pad,
                                                 n_ext, C);
  return (int)cudaGetLastError();
}
