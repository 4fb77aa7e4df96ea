// Banded GAT attention, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_attention_dma (v2) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py. Per destination
// row i of block-row blk = i / BLK, per graph b and head h:
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])   j < W
//   p     = softmax over the j with mask[blk, i % BLK, j] != 0
//   out[b, i, h, :] = sum_j p_j * x_ext[b, blk*BLK + j, h, :]
//
// A row with no unmasked entry (a padded band row: no self-loop) gets a
// uniform softmax over its W window, as the plain version does.
//
// Design: one warp per (b, row, head). Pass 1 reads the row's int8 mask and
// takes the masked logit max. Pass 2 walks the window 32 columns at a time;
// a warp ballot over the mask yields the set columns (about 5 of 896 on
// bigtown), and for each the warp reads one x row with the channels spread
// over its lanes. Masked columns are skipped, which is exact because their
// softmax weight is 0. The work and the x traffic therefore follow the
// mask's nonzeros, not the dense W window.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per thread block
constexpr int kPerLane = 8;             // channels per lane in one tile
constexpr int kTile = 32 * kPerLane;    // channels per tile
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
band_attention_fwd_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
                          const float* __restrict__ a_src_win,  // [nB, B, W, H]
                          const float* __restrict__ x_ext,      // [B, n_ext, H, C]
                          const int8_t* __restrict__ mask,      // [nB, BLK, W]
                          float* __restrict__ out,              // [B, n_pad, H, C]
                          int B, int nB, int BLK, int W, int H, int C,
                          float slope) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  if (warp >= (long long)B * n_pad * H) return;
  const int h = (int)(warp % H);
  const long long row = (warp / H) % n_pad;
  const long long b = warp / H / n_pad;
  const long long blk = row / BLK;
  const long long n_ext = n_pad + W - BLK;
  const long long HC = (long long)H * C;

  const int8_t* mrow = mask + row * W;  // [blk, row % BLK, :] == row * W
  const float* asrc = a_src_win + (blk * B + b) * W * H + h;
  const float ad = a_dst[(b * n_pad + row) * H + h];
  const float* xw = x_ext + (b * n_ext + blk * BLK) * HC + (long long)h * C;
  float* orow = out + (b * n_pad + row) * HC + (long long)h * C;

  // pass 1: masked max of the LeakyReLU logits
  float m = -INFINITY;
  bool any = false;
  for (int j = lane; j < W; j += 32) {
    if (mrow[j]) {
      float z = ad + asrc[(long long)j * H];
      z = z >= 0.f ? z : slope * z;
      m = fmaxf(m, z);
      any = true;
    }
  }
  for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
  const bool empty = !__any_sync(kFull, any);

  // pass 2: sum of p_j * x_j over the set columns, one channel tile at a time
  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    float Z = 0.f;
    for (int j0 = 0; j0 < W; j0 += 32) {
      const int j = j0 + lane;
      const bool on = j < W && (empty || mrow[j] != 0);
      float p = 0.f;
      if (on) {
        if (empty) {
          p = 1.f;
        } else {
          float z = ad + asrc[(long long)j * H];
          z = z >= 0.f ? z : slope * z;
          p = expf(z - m);
        }
      }
      unsigned bits = __ballot_sync(kFull, on);
      while (bits) {
        const int src = __ffs(bits) - 1;
        bits &= bits - 1;
        const float pj = __shfl_sync(kFull, p, src);
        Z += pj;
        const float* xr = xw + (long long)(j0 + src) * HC + c0;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int c = lane + 32 * k;
          if (c0 + c < C) acc[k] = fmaf(pj, __ldg(xr + c), acc[k]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = lane + 32 * k;
      if (c0 + c < C) orow[c0 + c] = acc[k] / Z;
    }
  }
}

}  // namespace

extern "C" int band_attention_fwd(const float* a_dst, const float* a_src_win,
                                  const float* x_ext, const int8_t* mask,
                                  float* out, int B, int nB, int BLK, int W,
                                  int H, int C, float slope, void* stream) {
  const long long warps = (long long)B * nB * BLK * H;
  if (warps == 0) return (int)cudaSuccess;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  band_attention_fwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                              (cudaStream_t)stream>>>(
      a_dst, a_src_win, x_ext, mask, out, B, nB, BLK, W, H, C, slope);
  return (int)cudaGetLastError();
}
