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
// Design: one warp per (b, row). The warp walks the row's W band entries 32
// at a time; a ballot on the nonzero entries yields the set columns (about 4
// of 896 on bigtown), and for each the warp reads one x row with the
// channels spread over its lanes. Zero entries are skipped, so the work and
// the x traffic follow the band's nonzeros, not the dense window.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per thread block
constexpr int kPerLane = 8;             // channels per lane in one tile
constexpr int kTile = 32 * kPerLane;    // channels per tile
constexpr unsigned kFull = 0xffffffffu;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
band_spmm_fwd_kernel(const T* __restrict__ band,       // [nB, BLK, W]
                     const float* __restrict__ x_ext,  // [B, n_ext, C]
                     float* __restrict__ out,          // [B, n_pad, C]
                     int B, int nB, int BLK, int W, int C) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  if (warp >= (long long)B * n_pad) return;
  const long long row = warp % n_pad;
  const long long b = warp / n_pad;
  const long long blk = row / BLK;
  const long long n_ext = n_pad + W - BLK;

  const T* brow = band + row * W;  // [blk, row % BLK, :] == row * W
  const float* xw = x_ext + (b * n_ext + blk * BLK) * C;
  float* orow = out + (b * n_pad + row) * C;

  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    for (int j0 = 0; j0 < W; j0 += 32) {
      const int j = j0 + lane;
      const float w = j < W ? static_cast<float>(brow[j]) : 0.f;
      unsigned bits = __ballot_sync(kFull, w != 0.f);
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const float wj = __shfl_sync(kFull, w, src);
        const float* xr = xw + (long long)(j0 + src) * C + c0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int c = lane + 32 * k;
          if (c0 + c < C) acc[k] = fmaf(wj, __ldg(xr + c), acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c0 + c < C) orow[c0 + c] = acc[k];
    }
  }
}

template <typename T>
int launch(const T* band, const float* x_ext, float* out, int B, int nB,
           int BLK, int W, int C, void* stream) {
  const long long warps = (long long)B * nB * BLK;
  if (warps == 0) return (int)cudaSuccess;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  band_spmm_fwd_kernel<T><<<(unsigned)blocks, kWarps * 32, 0,
                            (cudaStream_t)stream>>>(band, x_ext, out, B, nB,
                                                    BLK, W, C);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int band_spmm_fwd_i8(const int8_t* band, const float* x_ext,
                                float* out, int B, int nB, int BLK, int W,
                                int C, void* stream) {
  return launch(band, x_ext, out, B, nB, BLK, W, C, stream);
}

extern "C" int band_spmm_fwd_f32(const float* band, const float* x_ext,
                                 float* out, int B, int nB, int BLK, int W,
                                 int C, void* stream) {
  return launch(band, x_ext, out, B, nB, BLK, W, C, stream);
}
