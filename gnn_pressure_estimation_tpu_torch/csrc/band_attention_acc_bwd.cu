// Banded GAT attention, backward of the sliding-accumulator route, for
// Hopper (sm_90a).
//
// Replaces the backward of make_band_attention_acc (v3) in
// gnn_pressure_estimation_tpu/ops/pallas/band_attention.py (bwd_kernel,
// :1420). The forward is v2's (csrc/band_attention.cu), as v3 reuses it.
// With z_j = a_dst[b,i,h] + a_src_win[blk,b,j,h], p = softmax_j(LeakyReLU(z_j))
// over the set columns of row i (recomputed from the int8 mask: the forward
// saves nothing but its inputs) and dO the cotangent of the forward's output:
//
//   dp_j    = dO[b,i,h,:] . x_ext[b, blk*BLK + j, h, :]
//   delta_i = sum_j p_j dp_j
//   dz_j    = p_j (dp_j - delta_i) * (z_j >= 0 ? 1 : slope)
//   d a_dst[b,i,h]            = sum_j dz_j
//   d a_src_win[blk,b,j,h]    = sum over the block's rows i of dz_j
//   d x_ext[b, blk*BLK+j,h,:] = sum over the rows i of every block whose
//                               window holds that row of p_j dO[b,i,h,:]
//
// A row with no set column (a padded band row) got the uniform mean of its
// W window rows in the forward: it adds dO/W to each of them and nothing to
// the d a's.
//
// What carries over from the TPU kernel, and what does not. v3 absorbs
// window i into a [W_pad, H*C] VMEM accumulator, flushes the BLK rows that
// are final and slides by BLK: d x_ext goes straight onto the extended array
// with no windowed [nB, B, W, H*C] tensor and no fold. That carry needs the
// grid to run in order, which a GPU grid does not. What is kept is the idea:
// each extended row's d x_ext has one owner that sums it whole and writes it
// once, with no atomics and no windowed tensor. Four kernels, one launch of
// the wrapper:
//
//   1. colbits: the int8 mask as bits by column: word g of (blk, j) holds
//      mask[blk, 32g .. 32g+31, j]. Read once, coalesced; 1/8 of the mask.
//   2. rows:    one warp per (b, row, head) scans the row's int8 mask (a
//               warp ballot over 32 columns): the max m,
//               then Z and delta from e = exp(z - m) and dp (one warp-wide
//               dot product per set column), then d a_dst = sum of
//               dz = (e/Z)(dp - delta) * slope factor, dp recomputed, so each
//               dz is formed as the reference forms it (the shortcut
//               (sum e dp s - delta sum e s)/Z cancels). Writes m, 1/Z, delta
//               and d a_dst; a padded row gets 1/Z = 0.
//   3. empties: dO/W summed over each block's padded rows (band_common.cuh).
//   4. owner:   one warp owns one extended row e of one (graph, head); the
//               eight warps of a thread block own eight consecutive rows of
//               one BLK-row tile. The warp walks the <= ceil(W/BLK) block
//               rows whose windows hold e, reads the column bits of
//               j = e - blk*BLK, rebuilds each p = exp(z - m) / Z from the
//               row's statistics and accumulates p dO in registers; for the
//               same entries it forms dz from dp = dO . x_e and sums them
//               into d a_src_win[blk, b, j, h]. Every cell of d a_src_win and
//               every row of d x_ext is written once, by its owner.
//
// A thread block per whole tile (the TPU kernel's unit) would give 26 blocks
// per (graph, head) on bigtown, too few to fill 132 SMs at B 1; a warp per
// row gives B * n_ext * H warps. Summation runs in a fixed order, so a run
// repeats to the bit.
//
// Bound: bytes. x_ext and dO are read once and d x_ext written once at the
// byte bound; here each dO row is read once per set entry (about 4.6 per row
// on bigtown) and x_e once per owner. The flops (4 C per nonzero) are far
// below the f32 rate at that traffic. Offsets are 64-bit throughout.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include "band_common.cuh"

namespace {

constexpr int kPerLane = 8;             // channels per lane in one tile
constexpr int kTile = 32 * kPerLane;    // channels per tile

__global__ void __launch_bounds__(kWarps * 32)
colbits_kernel(const int8_t* __restrict__ mask,  // [nB, BLK, W]
               unsigned* __restrict__ bits,      // [nB, W, G]
               int nB, int BLK, int W, int G) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)nB * G * W) return;
  const int j = (int)(t % W);
  const int g = (int)((t / W) % G);
  const long long blk = t / W / G;
  const int8_t* m = mask + blk * BLK * (long long)W + j;
  unsigned w = 0u;
  for (int ii = 0; ii < 32; ++ii) {
    const int i = g * 32 + ii;
    if (i >= BLK) break;
    if (m[(long long)i * W]) w |= 1u << ii;
  }
  bits[(blk * W + j) * (long long)G + g] = w;
}

// dp = dO . x_j of the set column that this lane holds in the chunk of 32
// columns at j0 (0 elsewhere): one warp-wide dot product per set column
__device__ __forceinline__ float chunk_dp(bool on, int j0, const float* xw, const float* drow,
                                          long long HC, int C, int lane) {
  unsigned bits = __ballot_sync(kFull, on);
  float dp = 0.f;
  while (bits) {
    const int src = __ffs(bits) - 1;
    bits &= bits - 1;
    const float* xr = xw + (long long)(j0 + src) * HC;
    float part = 0.f;
    for (int c = lane; c < C; c += 32) part = fmaf(drow[c], __ldg(xr + c), part);
    part = warp_sum(part);
    if (lane == src) dp = part;
  }
  return dp;
}

__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
            const float* __restrict__ a_src_win,  // [nB, B, W, H]
            const float* __restrict__ x_ext,      // [B, n_ext, H, C]
            const float* __restrict__ dout,       // [B, n_pad, H, C]
            const int8_t* __restrict__ mask,      // [nB, BLK, W]
            float* __restrict__ st_m,             // [B, n_pad, H]
            float* __restrict__ st_iz,            // [B, n_pad, H]  1/Z, 0 on padded rows
            float* __restrict__ st_delta,         // [B, n_pad, H]
            float* __restrict__ d_a_dst,          // [B, n_pad, H]
            int B, int nB, int BLK, int W, int H, int C, float slope) {
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
  const long long at = (b * n_pad + row) * H + h;

  const int8_t* mrow = mask + row * W;  // [blk, row % BLK, :] == row * W
  const float* asrc = a_src_win + (blk * B + b) * W * H + h;
  const float ad = a_dst[at];
  const float* xw = x_ext + (b * n_ext + blk * BLK) * HC + (long long)h * C;
  const float* drow = dout + (b * n_pad + row) * HC + (long long)h * C;

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
  m = warp_max(m);
  if (!__any_sync(kFull, any)) {  // padded row: uniform softmax, no gradient to the a's
    if (lane == 0) {
      st_m[at] = 0.f;
      st_iz[at] = 0.f;
      st_delta[at] = 0.f;
      d_a_dst[at] = 0.f;
    }
    return;
  }

  // pass 2: Z = sum e and delta = sum e dp / Z over the set columns
  float Z = 0.f, N = 0.f;
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int j = j0 + lane;
    const bool on = j < W && mrow[j] != 0;
    float e = 0.f;
    if (on) {
      float z = ad + asrc[(long long)j * H];
      z = z >= 0.f ? z : slope * z;
      e = expf(z - m);
    }
    const float dp = chunk_dp(on, j0, xw, drow, HC, C, lane);
    Z += e;
    N = fmaf(e, dp, N);
  }
  Z = warp_sum(Z);
  const float iz = 1.f / Z;
  const float delta = warp_sum(N) * iz;

  // pass 3: d a_dst = sum dz, dz = p (dp - delta), slope where the
  // pre-activation is negative; dp recomputed
  float dsum = 0.f;
  for (int j0 = 0; j0 < W; j0 += 32) {
    const int j = j0 + lane;
    const bool on = j < W && mrow[j] != 0;
    const float dp = chunk_dp(on, j0, xw, drow, HC, C, lane);
    if (on) {
      const float zpre = ad + asrc[(long long)j * H];
      const float z = zpre >= 0.f ? zpre : slope * zpre;
      float dz = expf(z - m) * iz * (dp - delta);
      if (zpre < 0.f) dz *= slope;
      dsum += dz;
    }
  }
  dsum = warp_sum(dsum);
  if (lane == 0) {
    st_m[at] = m;
    st_iz[at] = iz;
    st_delta[at] = delta;
    d_a_dst[at] = dsum;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
owner_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
             const float* __restrict__ a_src_win,  // [nB, B, W, H]
             const float* __restrict__ x_ext,      // [B, n_ext, H, C]
             const float* __restrict__ dout,       // [B, n_pad, H, C]
             const unsigned* __restrict__ bits,    // [nB, W, G]
             const float* __restrict__ st_m,       // [B, n_pad, H]
             const float* __restrict__ st_iz,      // [B, n_pad, H]
             const float* __restrict__ st_delta,   // [B, n_pad, H]
             const float* __restrict__ S,          // [B, nB, H, C] or null
             const int* __restrict__ empty_ptr,    // [nB + 1]
             float* __restrict__ d_a_src_win,      // [nB, B, W, H]
             float* __restrict__ d_x_ext,          // [B, n_ext, H, C]
             int B, int nB, int BLK, int W, int H, int C, int G, float slope) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if (warp >= (long long)B * H * n_ext) return;
  const long long e = warp % n_ext;           // consecutive warps own consecutive rows
  const int h = (int)((warp / n_ext) % H);
  const long long b = warp / n_ext / H;
  const long long HC = (long long)H * C;

  // the blocks whose window [blk*BLK, blk*BLK + W) holds e
  const int blk_hi = (int)min((long long)nB - 1, e / BLK);
  const int blk_lo = e >= W ? (int)((e - W) / BLK + 1) : 0;
  const float* xe = x_ext + (b * n_ext + e) * HC + (long long)h * C;
  const float* dbase = dout + b * n_pad * HC + (long long)h * C;
  const long long st0 = b * n_pad * H + h;    // row r's statistics at st0 + r * H

  for (int c0 = 0; c0 < C; c0 += kTile) {
    const bool first = c0 == 0;               // the d a_src_win sums ride on the first tile
    float acc[kPerLane], xr[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      acc[k] = 0.f;
      xr[k] = c < C ? __ldg(xe + c) : 0.f;
    }
    for (int blk = blk_lo; blk <= blk_hi; ++blk) {
      const long long j = e - (long long)blk * BLK;
      const unsigned* cb = bits + ((long long)blk * W + j) * G;
      const float as = a_src_win[(((long long)blk * B + b) * W + j) * H + h];
      float dA = 0.f;
      for (int g0 = 0; g0 < G; g0 += 32) {
        const unsigned mine = g0 + lane < G ? cb[g0 + lane] : 0u;
        const int gn = min(32, G - g0);
        for (int g = 0; g < gn; ++g) {
          unsigned w = __shfl_sync(kFull, mine, g);
          while (w) {
            const int ii = __ffs(w) - 1;
            w &= w - 1;
            const long long row = (long long)blk * BLK + (long long)(g0 + g) * 32 + ii;
            const long long at = st0 + row * H;
            const float zpre = a_dst[at] + as;
            const float s = zpre >= 0.f ? 1.f : slope;
            const float p = expf(zpre * s - st_m[at]) * st_iz[at];
            const float* dr = dbase + row * HC;
            float part = 0.f;
#pragma unroll
            for (int k = 0; k < kPerLane; ++k) {
              const int c = c0 + lane + 32 * k;
              if (c < C) {
                const float d = __ldg(dr + c);
                acc[k] = fmaf(p, d, acc[k]);
                part = fmaf(d, xr[k], part);
              }
            }
            if (first) {
              // dp over all C channels: this tile's share, then the others'
              for (int c = kTile + lane; c < C; c += 32) part = fmaf(__ldg(dr + c), __ldg(xe + c), part);
              const float dp = warp_sum(part);
              dA = fmaf(p * s, dp - st_delta[at], dA);
            }
          }
        }
      }
      if (first && lane == 0) d_a_src_win[(((long long)blk * B + b) * W + j) * H + h] = dA;
      if (S != nullptr && empty_ptr[blk] != empty_ptr[blk + 1]) {
        const float* sr = S + (((long long)b * nB + blk) * H + h) * C;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          const int c = c0 + lane + 32 * k;
          if (c < C) acc[k] += sr[c];
        }
      }
    }
    float* orow = d_x_ext + (b * n_ext + e) * HC + (long long)h * C;
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + lane + 32 * k;
      if (c < C) orow[c] = acc[k];
    }
  }
}

}  // namespace

// scratch_bits: [nB, W, ceil(BLK/32)] u32; scratch_stats: [3, B, n_pad, H]
// f32; scratch_s: [B, nB, H, C] f32, read only when n_empty > 0. All outputs
// are written in full.
extern "C" int band_attention_acc_bwd(
    const float* a_dst, const float* a_src_win, const float* x_ext,
    const float* dout, const int8_t* mask, const int* empty_ptr,
    const int* empty_row, unsigned* scratch_bits, float* scratch_stats,
    float* scratch_s, float* d_a_dst, float* d_a_src_win, float* d_x_ext,
    int B, int nB, int BLK, int W, int H, int C, int n_empty, float slope,
    void* stream) {
  const long long n_pad = (long long)nB * BLK;
  const long long n_ext = n_pad + W - BLK;
  if ((long long)B * n_pad * H == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  const int G = (BLK + 31) / 32;
  const long long rows = (long long)B * n_pad * H;
  float* st_m = scratch_stats;
  float* st_iz = scratch_stats + rows;
  float* st_delta = scratch_stats + 2 * rows;

  const long long nbits = (long long)nB * G * W;
  colbits_kernel<<<(unsigned)((nbits + kWarps * 32 - 1) / (kWarps * 32)), kWarps * 32, 0,
                   st>>>(mask, scratch_bits, nB, BLK, W, G);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rows_kernel<<<blocks_for(rows), kWarps * 32, 0, st>>>(
      a_dst, a_src_win, x_ext, dout, mask, st_m, st_iz, st_delta, d_a_dst, B,
      nB, BLK, W, H, C, slope);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (n_empty > 0) {
    err = (cudaError_t)launch_empties(dout, empty_ptr, empty_row, scratch_s, B, nB, BLK, W, H, C, st);
    if (err != cudaSuccess) return (int)err;
  }
  owner_kernel<<<blocks_for((long long)B * H * n_ext), kWarps * 32, 0, st>>>(
      a_dst, a_src_win, x_ext, dout, scratch_bits, st_m, st_iz, st_delta,
      n_empty > 0 ? scratch_s : nullptr, empty_ptr, d_a_src_win, d_x_ext, B,
      nB, BLK, W, H, C, G, slope);
  return (int)cudaGetLastError();
}
