// Banded GAT attention with a streaming softmax, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_band_attention_flash (v4) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (fwd_kernel and
// its batch-folded twin: the same function on another grid). Per destination
// row i of block-row blk = i / BLK, per graph b and head h:
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])   j < W
//   m     = max of z_j over the set columns of mask row i
//   Z     = sum of exp(z_j - m) over them
//   out[b, i, h, :] = sum_j exp(z_j - m) / Z * x_ext[b, blk*BLK + j, h, :]
//
// and it returns m and Z [B, n_pad, H] beside out: the backward
// (csrc/band_attention_flash_bwd.cu) rebuilds each weight from them and never
// takes a row maximum or sum again.
//
// What makes it the streaming kernel: the row's state is O(1) in W. The TPU
// kernel streams dense W-chunks of the window and the mask; here the mask is
// a fraction of a percent dense at the sizes this kernel is for (W 1920 on a
// 23k-node network), so the row's set columns come compressed (BandIndex
// row lists) and are streamed 32 at a time. Per chunk: the lanes' logits, the
// chunk maximum, m_new = max(m, chunk max), alpha = exp(m - m_new); Z and the
// C-wide accumulator are rescaled by alpha and take the chunk's
// exp(z - m_new) terms. The sign of LeakyReLU is that of the one f32 sum
// a_dst + a_src (z >= 0), as in the TPU kernel.
//
// A row with no set column (a padded band row: no self-loop) gets a uniform
// softmax over its W window, as the plain version does: the mean of the
// window's W rows of x_ext, m = -1e9 (the masked logit), Z = W. The window of
// the last block-row ends at the array's last row, so no read goes past it.
//
// One warp per (b, row, head), channels over the lanes in tiles of 128 or 256; a
// wider C walks the row's list once per tile. 64-bit offsets throughout.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kMaxPerLane = 8;          // channels per lane in one tile, at most
constexpr float kMaskedLogit = -1e9f;   // what the plain version gives a masked column
constexpr float kRunningMaxInit = -3e38f;

// kPerLane channels per lane in one tile: 4 where C <= 128 (fewer registers,
// more warps in flight), else 8.
template <int kPerLane>
__global__ void __launch_bounds__(kWarps * 32)
band_attention_flash_fwd_kernel(
    const float* __restrict__ a_dst,      // [B, n_pad, H]
    const float* __restrict__ a_src_win,  // [nB, B, W, H]
    const float* __restrict__ x_ext,      // [B, n_ext, H, C]
    const int* __restrict__ row_ptr,      // [n_pad + 1]
    const int* __restrict__ col,          // [nnz]
    float* __restrict__ out,              // [B, n_pad, H, C]
    float* __restrict__ m_out,            // [B, n_pad, H]
    float* __restrict__ z_out,            // [B, n_pad, H]
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
  const long long n_ext = n_pad + W - BLK;
  const long long HC = (long long)H * C;

  const long long stat = (b * n_pad + row) * H + h;
  const float* asrc = a_src_win + (blk * B + b) * W * H + h;
  const float ad = a_dst[stat];
  const float* xw = x_ext + (b * n_ext + blk * BLK) * HC + (long long)h * C;
  float* orow = out + (b * n_pad + row) * HC + (long long)h * C;
  const int k0 = row_ptr[row], k1 = row_ptr[row + 1];

  if (k0 == k1) {  // no set column: the mean of the window's rows
    for (int c = lane; c < C; c += 32) {
      float acc = 0.f;
      for (int j = 0; j < W; ++j) acc += __ldg(xw + (long long)j * HC + c);
      orow[c] = acc / (float)W;
    }
    if (lane == 0) {
      m_out[stat] = kMaskedLogit;
      z_out[stat] = (float)W;
    }
    return;
  }

  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    float m = kRunningMaxInit, Z = 0.f;
    for (int s0 = k0; s0 < k1; s0 += 32) {   // one chunk of the row's list
      const int k = s0 + lane;
      int j = 0;
      float z = kRunningMaxInit;
      if (k < k1) {
        j = col[k];
        z = ad + asrc[(long long)j * H];
        z = z >= 0.f ? z : slope * z;
      }
      const float m_new = fmaxf(m, warp_max(z));
      const float alpha = expf(m - m_new);
      const float p = k < k1 ? expf(z - m_new) : 0.f;
      Z = Z * alpha + warp_sum(p);
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) acc[q] *= alpha;
      const int cnt = min(32, k1 - s0);
      for (int s = 0; s < cnt; ++s) {
        const float ps = __shfl_sync(kFull, p, s);
        const float* xr = xw + (long long)__shfl_sync(kFull, j, s) * HC + c0;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c0 + c < C) acc[q] = fmaf(ps, __ldg(xr + c), acc[q]);
        }
      }
      m = m_new;
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < C) orow[c0 + c] = acc[q] / Z;
    }
    if (c0 == 0 && lane == 0) {
      m_out[stat] = m;
      z_out[stat] = Z;
    }
  }
}

}  // namespace

extern "C" int band_attention_flash_fwd(
    const float* a_dst, const float* a_src_win, const float* x_ext,
    const int* row_ptr, const int* col, float* out, float* m_out, float* z_out,
    int B, int nB, int BLK, int W, int H, int C, float slope, void* stream) {
  const long long warps = (long long)B * nB * BLK * H;
  if (warps == 0) return (int)cudaSuccess;
  auto kernel = C <= 128 ? band_attention_flash_fwd_kernel<4>
                         : band_attention_flash_fwd_kernel<kMaxPerLane>;
  kernel<<<blocks_for(warps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      a_dst, a_src_win, x_ext, row_ptr, col, out, m_out, z_out, B, nB, BLK, W,
      H, C, slope);
  return (int)cudaGetLastError();
}
