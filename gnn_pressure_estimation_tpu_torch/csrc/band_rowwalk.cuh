// The row-list walk of the band-attention forwards (csrc/band_attention.cu,
// v2, csrc/band_attention_flash.cu, v4, and in window layout
// csrc/band_attention_window.cu, v1): one function, computed the same way for
// all. Per destination row i of block-row blk = i / BLK, per graph b
// and head h, over the set columns j of mask row i:
//
//   z_j   = LeakyReLU(a_dst[b, i, h] + a_src_win[blk, b, j, h])
//   m     = max_j z_j,   Z = sum_j exp(z_j - m)
//   out[b, i, h, :] = sum_j exp(z_j - m) / Z * x_ext[b, blk*BLK + j, h, :]
//
// The sign of LeakyReLU is that of the one f32 sum a_dst + a_src (z >= 0). A
// row with no set column (a padded band row: no self-loop) gets a uniform
// softmax over its W window: the mean of the window's W rows, m = -1e9 (the
// masked logit) and Z = W. kStats: the kernel also writes m and Z
// [B, n_pad, H], which the flash backward takes (v2's backward recomputes
// them).
//
// The mask comes compressed (BandIndex row lists: row_ptr, col); the kernel
// never reads the int8 mask.
//
// Bound: bytes. Each row gathers ~4.5 x rows (bigtown; ~4.6 on meganet):
// about 0.5 FLOP a byte in f32. Tensor cores would help only as a dense
// product over the W window, ~200x the useful work, and their TF32 inputs
// would break the 1e-4 gate against the plain version; so TMA and wgmma do
// not apply. What the design buys instead:
// - one warp per (b, row), all heads: a row's H*C channels are contiguous in
//   x_ext and out, so the warp reads each neighbour's whole row once (1 KB at
//   H*C 256: two float4 a lane) and the row list once, not once a head. The
//   logits of an entry are H adjacent floats of a_src_win. Max and sum are
//   per head, by warp shuffles; a float4 never straddles two heads when
//   C % 4 == 0 (a scalar variant serves other C or an unaligned x_ext);
// - one pass over the list: up to 32 entries a chunk, one a lane. The x rows
//   of the chunk's first kGroup entries are loaded as soon as col is known,
//   before the softmax; the weights p go to shared memory (32*H a warp) and
//   the FMAs follow in list order. A row past 32 entries streams: running
//   max m and sum Z per head, m_new = max(m, chunk max), the accumulator and
//   Z rescaled by exp(m - m_new) at each chunk; out = acc / Z. m and Z are
//   those of the same walk that wrote out, so the flash backward's weights
//   exp(z - m) / Z and its delta = sum dO*out agree to the bit;
// - latency hidden by warps in flight: each row is a chain of dependent
//   loads (row_ptr, col, then x and the logits), so time follows the warps an
//   SM holds more than bytes. The kernel is held to 64 registers (four thread
//   blocks of eight warps an SM), with two entries' x rows loaded ahead
//   (kGroup 2) rather than four at twice the registers;
// - padded rows once a block, not once a row: a pre-pass (window_mean_kernel)
//   sums the W window rows of each block that holds such a row (BandIndex
//   empty_ptr), one thread block per (b, block, 32 channels); the main pass
//   copies that mean;
// - L2 reuse: the grid is b-major, row-minor, so neighbouring warps take
//   neighbouring RCM rows, whose x rows overlap.
// Channels run in tiles of 128*NV (NV float4 a lane: 1 for H*C <= 128, else
// 2); a wider H*C walks the list once a tile. Heads run in groups of at most
// kHeadGroup, whose weights fit the warp's shared memory (35 floats a head);
// a group's channels [h0*C, (h0+hg)*C) are contiguous, so it is tiled as a
// row of hg*C channels.
//
// kBf16: the bf16-operand instance of v2 and v4 (the TPU kernels' mx =
// bfloat16, GATRes's attn_dtype), a walk of its own (bf16_rowwalk) over x_ext
// stored in bf16: the glue rounds each projected row once as it writes the
// extended rows, so the kernel gathers 2-byte rows, half the f32 bytes and
// half the staging registers. A lane holds the f32 walk's channels, packed:
// kVec, one 8-byte quad of 4 bf16 a 128-channel slot where the f32 walk
// loads a float4 (C % 4 == 0, an aligned x_ext: the wrapper checks); scalar,
// one bf16 at a time. Each value is widened (__bfloat162float) as it is
// multiplied. The products' weight is
// the one the TPU kernel hands its matmul, rounded to bf16 (operand<>,
// csrc/band_common.cuh): v2 the normalised p = exp(z - m) / Z, so out = sum
// bf16(p) bf16(x); v4 the numerator exp(z - m), so out = sum bf16(e) bf16(x)
// / Z with Z the sum of the unrounded numerators. Either needs the row's
// final m (and v2 its Z) before the first product, so this walk never
// rescales: a list of at most 32 entries is one chunk, whose warp reductions
// give both; a longer list takes a sweep for m and one for Z first. Z is
// summed in double and rounded once (warp_sum_d), so the rounded weight does
// not depend on the order of the sum. The FMAs run in list order per channel,
// as in the f32 walk, so the output is that of rounding f32 rows on load.
// Padded rows get the window mean of the stored bf16 rows, summed in f32
// (window_mean_bf16_kernel). kBf16Group entries' rows are loaded ahead. With
// half the staging registers and no rescale, the NV 1 instance is held to 48
// registers, so an SM holds five thread blocks of it (the latency-bound walk
// gains from the warps in flight); NV 2 keeps four.
//
// kWindow: the window layout of the v1 forward (csrc/band_attention_window.cu).
// x is x_win [nB, B, W, H, C], each block's W window rows materialised, and
// row j of block blk's window is x_win[blk, b, j] where v2 reads
// x_ext[b, blk*BLK + j]; the window-mean pre-pass reads the same rows.
// Nothing else changes: the same walk, summed in the same order, so on an
// x_win cut from x_ext the two forwards agree to the bit. Offsets are
// 64-bit: a window tensor passes 2^31 elements at a 23k-node network. The
// window layout has no bf16 and no statistics instance (v1 has neither).

#pragma once

#include <type_traits>

#include "band_common.cuh"

namespace {

constexpr int kGroup = 2;                // entries whose x rows load before their FMAs
constexpr int kMinBlocks = 4;            // thread blocks an SM must hold: <= 64 registers
constexpr int kBf16Group = 2;            // the bf16 walk's: 4 spilled more and was slower
constexpr int kBf16MinBlocks[2] = {5, 4};  // the bf16 walk's at NV 1 (<= 48 registers), NV 2
constexpr int kMeanWarps = 16;           // warps of one window-mean block
constexpr int kHeadGroup = 32;           // heads of one pass over the list
constexpr float kRunningMaxInit = -3e38f;
constexpr float kMaskedLogit = -1e9f;    // what the plain version gives a masked column

// the element type of the rows the walk gathers
template <bool kBf16>
using RowT = std::conditional_t<kBf16, __nv_bfloat16, float>;

__device__ __forceinline__ float row_value(const float* p) { return __ldg(p); }
__device__ __forceinline__ float row_value(const __nv_bfloat16* p) {
  return __bfloat162float(__ldg(p));
}

// mean[b, blk, c] = sum_{j < W} x_ext[b, blk*BLK + j, c] / W for each block
// with a row of no set column; the other blocks leave at once and their
// mean is not read. One thread block per (b, blk) and 32 channels; its warps
// take every kMeanWarps-th row and their partial sums are added in warp order.
// kWindow: the rows are x_win[blk, b, 0 .. W-1] (the grid's x is B * nB).
template <bool kWindow, typename T>
__device__ __forceinline__ void window_mean_block(const T* __restrict__ x_ext,
                                                  const int* __restrict__ empty_ptr,
                                                  float* __restrict__ mean, int nB, int BLK,
                                                  int W, int HC) {
  const long long bb = blockIdx.x;                       // b * nB + blk
  const long long blk = bb % nB, b = bb / nB;
  if (empty_ptr[blk] == empty_ptr[blk + 1]) return;      // uniform over the block
  __shared__ float part[kMeanWarps][32];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int c = blockIdx.y * 32 + lane;
  const long long n_ext = (long long)nB * BLK + W - BLK;
  float acc = 0.f;
  if (c < HC) {
    const T* xc = kWindow ? x_ext + (blk * (gridDim.x / nB) + b) * W * HC + c
                          : x_ext + (b * n_ext + blk * BLK) * HC + c;
    for (int j = wid; j < W; j += kMeanWarps) acc += row_value(xc + (long long)j * HC);
  }
  part[wid][lane] = acc;
  __syncthreads();
  if (wid == 0 && c < HC) {
    float s = 0.f;
    for (int w = 0; w < kMeanWarps; ++w) s += part[w][lane];
    mean[bb * HC + c] = s / (float)W;
  }
}

template <bool kWindow>
__global__ void __launch_bounds__(kMeanWarps * 32)
window_mean_kernel(const float* __restrict__ x_ext,     // [B, n_ext, HC]; kWindow x_win
                   const int* __restrict__ empty_ptr,   // [nB + 1]
                   float* __restrict__ mean,            // [B, nB, HC]
                   int nB, int BLK, int W, int HC) {
  window_mean_block<kWindow>(x_ext, empty_ptr, mean, nB, BLK, W, HC);
}

// the same over the bf16 rows of the bf16-operand instances
__global__ void __launch_bounds__(kMeanWarps * 32)
window_mean_bf16_kernel(const __nv_bfloat16* __restrict__ x_ext, const int* __restrict__ empty_ptr,
                        float* __restrict__ mean, int nB, int BLK, int W, int HC) {
  window_mean_block<false>(x_ext, empty_ptr, mean, nB, BLK, W, HC);
}

// The warp's destination row (one warp per (b, row)): its lane, its warp in
// the block, where the row lies, its list [k0, k1) and its output row.
struct WalkRow {
  int lane, wib;
  long long b, blk, n_ext, stat;
  int k0, k1;
  float* orow;
};

// Fills r for this warp; false when the warp has no row, or when the row has
// no set column: that row is written here, the block's window mean (kStats:
// m = -1e9, Z = W), and the walk is not run.
template <bool kStats>
__device__ __forceinline__ bool begin_row(const int* __restrict__ row_ptr,
                                          const float* __restrict__ mean, float* __restrict__ out,
                                          float* __restrict__ m_out, float* __restrict__ z_out,
                                          int B, int nB, int BLK, int W, int H, int C,
                                          WalkRow& r) {
  r.lane = threadIdx.x & 31;
  r.wib = threadIdx.x >> 5;
  const long long warp = (long long)blockIdx.x * kWarps + r.wib;
  const long long n_pad = (long long)nB * BLK;
  if (warp >= (long long)B * n_pad) return false;
  const long long row = warp % n_pad;
  r.b = warp / n_pad;
  r.blk = row / BLK;
  r.n_ext = n_pad + W - BLK;
  const int HC = H * C;
  r.stat = (r.b * n_pad + row) * H;
  r.orow = out + (r.b * n_pad + row) * HC;
  r.k0 = row_ptr[row];
  r.k1 = row_ptr[row + 1];
  if (r.k0 == r.k1) {  // no set column: the block's window mean
    const float* mrow = mean + (r.b * nB + r.blk) * HC;
    for (int c = r.lane; c < HC; c += 32) r.orow[c] = mrow[c];
    if (kStats)
      for (int h = r.lane; h < H; h += 32) {
        m_out[r.stat + h] = kMaskedLogit;
        z_out[r.stat + h] = (float)W;
      }
    return false;
  }
  return true;
}

// kBf16, a list of more than 32 entries: the row's max m and sum Z (in
// double, rounded once) of heads h0 .. h0+hg-1 into m_sh, z_sh (lane 0
// writes). Out of line: inlined, its registers weighed on the walk's (more
// spills at the 64-register cap, a slower walk), though no row of bigtown or
// meganet takes it.
template <bool kLogit>
__device__ __noinline__ void row_stats_sweep(const float* __restrict__ ad,
                                             const float* __restrict__ asrc,
                                             const int* __restrict__ col, int k0, int k1, int H,
                                             int h0, int hg, float slope, float* m_sh,
                                             float* z_sh, int lane) {
  for (int h = 0; h < hg; ++h) {
    auto logit = [&](int k) {
      return logit_of<kLogit>(__ldg(ad + h0 + h) + __ldg(asrc + (long long)col[k] * H + h0 + h),
                              slope);
    };
    float m = kRunningMaxInit;
    for (int k = k0 + lane; k < k1; k += 32) m = fmaxf(m, logit(k));
    m = warp_max(m);
    double zs = 0.0;
    for (int k = k0 + lane; k < k1; k += 32) zs += (double)expf(logit(k) - m);
    zs = warp_sum_d(zs);
    if (lane == 0) {
      m_sh[h] = m;
      z_sh[h] = (float)zs;
    }
  }
}

// The bf16-operand walk (kBf16; see the note at the top) of the warp's row r,
// which has a set column: arguments as band_rowwalk_kernel's, x_ext [B,
// n_ext, H, C] in bf16.
template <int NV, bool kVec, bool kStats, bool kLogit>
__device__ __forceinline__ void bf16_rowwalk(const WalkRow& r, const float* __restrict__ a_dst,
                                             const float* __restrict__ a_src_win,
                                             const __nv_bfloat16* __restrict__ x_ext,
                                             const int* __restrict__ col,
                                             float* __restrict__ m_out, float* __restrict__ z_out,
                                             int B, int BLK, int W, int H, int C,
                                             float slope) {
  extern __shared__ float smem[];        // per warp: p [32][G], then m, Z [G]
  constexpr int kTile = 128 * NV;
  const auto [lane, wib, b, blk, n_ext, stat, k0, k1, orow] = r;
  const int HC = H * C;

  const int G = min(H, kHeadGroup);
  float* p_sh = smem + wib * 35 * G;
  float* m_sh = p_sh + 32 * G;
  float* z_sh = m_sh + G;
  const float* ad = a_dst + stat;
  const float* asrc = a_src_win + (blk * B + b) * (long long)W * H;
  const __nv_bfloat16* xw = x_ext + (b * n_ext + blk * BLK) * HC;
  const bool one_chunk = k1 - k0 <= 32;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int hg = min(G, H - h0);           // heads h0 .. h0+hg-1, channels up to ce
    const int ce = (h0 + hg) * C;
    if (!one_chunk) {                        // the row's final m and Z, before any product
      row_stats_sweep<kLogit>(ad, asrc, col, k0, k1, H, h0, hg, slope, m_sh, z_sh, lane);
      __syncwarp();
    }
    for (int c0 = h0 * C; c0 < ce; c0 += kTile) {
      // the group's head of each of the lane's channels (hg: past ce, never read)
      int head[NV][4];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = bf16_channel<kVec>(c0, lane, v, e);
          head[v][e] = c < ce ? c / C - h0 : hg;
        }
      float4 acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);

      for (int s0 = k0; s0 < k1; s0 += 32) {   // one chunk of the row's list
        const int k = s0 + lane;
        const bool on = k < k1;
        const int jl = on ? col[k] : 0;
        const int cnt = min(32, k1 - s0);

        // the first group's x rows, in flight while the weights are formed
        uint2 xv[kBf16Group][NV];
#pragma unroll
        for (int q = 0; q < kBf16Group; ++q)
          load_bf16_quads<NV, kVec>(xw + (long long)__shfl_sync(kFull, jl, min(q, cnt - 1)) * HC,
                                    c0, lane, ce, xv[q]);

        // per head: the weights, from the row's final m and Z
        for (int h = 0; h < hg; ++h) {
          float z = kRunningMaxInit;
          if (on) {
            z = logit_of<kLogit>(__ldg(ad + h0 + h) + __ldg(asrc + (long long)jl * H + h0 + h),
                                 slope);
          }
          float m, Z;
          if (one_chunk) {                   // the chunk is the row: its max and sum
            m = warp_max(z);
            Z = (float)warp_sum_d(on ? (double)expf(z - m) : 0.0);
            if (lane == 0) {
              m_sh[h] = m;
              z_sh[h] = Z;
            }
          } else {                           // a longer list's, from the sweeps above
            m = m_sh[h];
            Z = z_sh[h];
          }
          const float e = on ? expf(z - m) : 0.f;
          p_sh[lane * G + h] = operand<true>(kStats ? e : e / Z);
        }
        __syncwarp();

        for (int g = 0; g < cnt; g += kBf16Group) {
          if (g > 0) {
#pragma unroll
            for (int q = 0; q < kBf16Group; ++q)
              load_bf16_quads<NV, kVec>(
                  xw + (long long)__shfl_sync(kFull, jl, min(g + q, cnt - 1)) * HC, c0, lane, ce,
                  xv[q]);
          }
#pragma unroll
          for (int q = 0; q < kBf16Group; ++q) {
            if (g + q < cnt) {
              const float* ps = p_sh + (g + q) * G;
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                if (head[v][0] < hg) acc[v].x = fmaf(ps[head[v][0]], bf16_elem(xv[q][v], 0), acc[v].x);
                if (head[v][1] < hg) acc[v].y = fmaf(ps[head[v][1]], bf16_elem(xv[q][v], 1), acc[v].y);
                if (head[v][2] < hg) acc[v].z = fmaf(ps[head[v][2]], bf16_elem(xv[q][v], 2), acc[v].z);
                if (head[v][3] < hg) acc[v].w = fmaf(ps[head[v][3]], bf16_elem(xv[q][v], 3), acc[v].w);
              }
            }
          }
        }
        __syncwarp();                          // p_sh is read before the next chunk writes it
      }

      // v2's weights came normalised: out = acc; v4's: out = acc / Z
      auto fin = [&](float a, int h) { return kStats ? a / z_sh[h] : a; };
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (kVec) {
          const int c = bf16_channel<true>(c0, lane, v, 0);
          if (c < ce)
            *reinterpret_cast<float4*>(orow + c) =
                make_float4(fin(acc[v].x, head[v][0]), fin(acc[v].y, head[v][0]),
                            fin(acc[v].z, head[v][0]), fin(acc[v].w, head[v][0]));
        } else {
          const int c = bf16_channel<false>(c0, lane, v, 0);
          if (c < ce) orow[c] = fin(acc[v].x, head[v][0]);
          if (c + 32 < ce) orow[c + 32] = fin(acc[v].y, head[v][1]);
          if (c + 64 < ce) orow[c + 64] = fin(acc[v].z, head[v][2]);
          if (c + 96 < ce) orow[c + 96] = fin(acc[v].w, head[v][3]);
        }
      }
      if (kStats && c0 == h0 * C)              // every tile walks alike: the first one writes
        for (int h = lane; h < hg; h += 32) {
          m_out[stat + h0 + h] = m_sh[h];
          z_out[stat + h0 + h] = z_sh[h];
        }
      __syncwarp();                            // m_sh, z_sh are read before the next group's
    }
  }
}

// The f32 walk (see the note at the top) of the warp's row r, which has a
// set column: arguments as band_rowwalk_kernel's.
template <int NV, bool kVec, bool kStats, bool kWindow, bool kLogit>
__device__ __forceinline__ void f32_rowwalk(const WalkRow& r, const float* __restrict__ a_dst,
                                            const float* __restrict__ a_src_win,
                                            const float* __restrict__ x_ext,
                                            const int* __restrict__ col,
                                            float* __restrict__ m_out, float* __restrict__ z_out,
                                            int B, int BLK, int W, int H, int C,
                                            float slope) {
  extern __shared__ float smem[];        // per warp: p [32][G], then m, Z, alpha [G]
  constexpr int kTile = 128 * NV;
  const auto [lane, wib, b, blk, n_ext, stat, k0, k1, orow] = r;
  const int HC = H * C;

  const int G = min(H, kHeadGroup);
  float* p_sh = smem + wib * 35 * G;
  float* m_sh = p_sh + 32 * G;
  float* z_sh = m_sh + G;
  float* al_sh = z_sh + G;
  const float* ad = a_dst + stat;
  const float* asrc = a_src_win + (blk * B + b) * (long long)W * H;
  const float* xw = kWindow ? x_ext + (blk * B + b) * W * HC    // the block's window rows
                            : x_ext + (b * n_ext + blk * BLK) * HC;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int hg = min(G, H - h0);         // heads h0 .. h0+hg-1, channels up to ce
    const int ce = (h0 + hg) * C;
    for (int c0 = h0 * C; c0 < ce; c0 += kTile) {
      // the group's head of each of the lane's channels (hg: past ce, never read)
      int head[NV][4];
#pragma unroll
      for (int v = 0; v < NV; ++v)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane + 32 * e;
          head[v][e] = c < ce ? c / C - h0 : hg;
        }
      float4 acc[NV];
#pragma unroll
      for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int h = lane; h < hg; h += 32) {
        m_sh[h] = kRunningMaxInit;
        z_sh[h] = 0.f;
      }
      __syncwarp();

      for (int s0 = k0; s0 < k1; s0 += 32) {   // one chunk of the row's list
        const int k = s0 + lane;
        const bool on = k < k1;
        const int jl = on ? col[k] : 0;
        const int cnt = min(32, k1 - s0);

        // the first group's x rows, in flight while the softmax is formed
        float4 xv[kGroup][NV];
#pragma unroll
        for (int q = 0; q < kGroup; ++q) {
          const float* xr = xw + (long long)__shfl_sync(kFull, jl, min(q, cnt - 1)) * HC;
#pragma unroll
          for (int v = 0; v < NV; ++v) {
            xv[q][v] = load_slot<kVec>(
                xr, kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane, ce);
          }
        }

        // per head: the chunk's logits, the running max, the rescale, the weights
        for (int h = 0; h < hg; ++h) {
          float z = kRunningMaxInit;
          if (on)
            z = logit_of<kLogit>(__ldg(ad + h0 + h) + __ldg(asrc + (long long)jl * H + h0 + h),
                                 slope);
          const float m_old = m_sh[h];
          const float m_new = fmaxf(m_old, warp_max(z));
          const float p = on ? expf(z - m_new) : 0.f;
          const float psum = warp_sum(p);
          p_sh[lane * G + h] = p;
          __syncwarp();                        // every lane has read m_sh[h]
          if (lane == 0) {
            const float alpha = expf(m_old - m_new);
            al_sh[h] = alpha;
            z_sh[h] = z_sh[h] * alpha + psum;
            m_sh[h] = m_new;
          }
        }
        __syncwarp();

#pragma unroll
        for (int v = 0; v < NV; ++v) {
          acc[v].x *= head[v][0] < hg ? al_sh[head[v][0]] : 0.f;
          acc[v].y *= head[v][1] < hg ? al_sh[head[v][1]] : 0.f;
          acc[v].z *= head[v][2] < hg ? al_sh[head[v][2]] : 0.f;
          acc[v].w *= head[v][3] < hg ? al_sh[head[v][3]] : 0.f;
        }

        for (int g = 0; g < cnt; g += kGroup) {
          if (g > 0) {
#pragma unroll
            for (int q = 0; q < kGroup; ++q) {
              const float* xr =
                  xw + (long long)__shfl_sync(kFull, jl, min(g + q, cnt - 1)) * HC;
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                xv[q][v] = load_slot<kVec>(
                    xr, kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane, ce);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < kGroup; ++q) {
            if (g + q < cnt) {
              const float* ps = p_sh + (g + q) * G;
#pragma unroll
              for (int v = 0; v < NV; ++v) {
                if (head[v][0] < hg) acc[v].x = fmaf(ps[head[v][0]], xv[q][v].x, acc[v].x);
                if (head[v][1] < hg) acc[v].y = fmaf(ps[head[v][1]], xv[q][v].y, acc[v].y);
                if (head[v][2] < hg) acc[v].z = fmaf(ps[head[v][2]], xv[q][v].z, acc[v].z);
                if (head[v][3] < hg) acc[v].w = fmaf(ps[head[v][3]], xv[q][v].w, acc[v].w);
              }
            }
          }
        }
        __syncwarp();                          // p_sh is read before the next chunk writes it
      }

#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if (kVec) {
          const int c = c0 + 128 * v + 4 * lane;
          if (c < ce) {
            const float Z = z_sh[head[v][0]];
            *reinterpret_cast<float4*>(orow + c) =
                make_float4(acc[v].x / Z, acc[v].y / Z, acc[v].z / Z, acc[v].w / Z);
          }
        } else {
          const int c = c0 + 128 * v + lane;
          if (c < ce) orow[c] = acc[v].x / z_sh[head[v][0]];
          if (c + 32 < ce) orow[c + 32] = acc[v].y / z_sh[head[v][1]];
          if (c + 64 < ce) orow[c + 64] = acc[v].z / z_sh[head[v][2]];
          if (c + 96 < ce) orow[c + 96] = acc[v].w / z_sh[head[v][3]];
        }
      }
      if (kStats && c0 == h0 * C)              // every tile walks alike: the first one writes
        for (int h = lane; h < hg; h += 32) {
          m_out[stat + h0 + h] = m_sh[h];
          z_out[stat + h0 + h] = z_sh[h];
        }
      __syncwarp();                            // z_sh is read before the next tile resets it
    }
  }
}

template <int NV, bool kVec, bool kStats, bool kWindow, bool kBf16, bool kLogit>
__global__ void __launch_bounds__(kWarps * 32, kBf16 ? kBf16MinBlocks[NV - 1] : kMinBlocks)
band_rowwalk_kernel(const float* __restrict__ a_dst,      // [B, n_pad, H]
                    const float* __restrict__ a_src_win,  // [nB, B, W, H]
                    const RowT<kBf16>* __restrict__ x_ext,  // [B, n_ext, H, C]; kWindow x_win
                    const int* __restrict__ row_ptr,      // [n_pad + 1]
                    const int* __restrict__ col,          // [nnz]
                    const float* __restrict__ mean,       // [B, nB, H*C]
                    float* __restrict__ out,              // [B, n_pad, H, C]
                    float* __restrict__ m_out,            // [B, n_pad, H] (kStats)
                    float* __restrict__ z_out,            // [B, n_pad, H] (kStats)
                    int B, int nB, int BLK, int W, int H, int C,
                    float slope) {
  WalkRow r;
  if (!begin_row<kStats>(row_ptr, mean, out, m_out, z_out, B, nB, BLK, W, H, C, r)) return;
  if constexpr (kBf16) {
    static_assert(!kWindow, "the window layout has no bf16 instance");
    bf16_rowwalk<NV, kVec, kStats, kLogit>(r, a_dst, a_src_win, x_ext, col, m_out, z_out, B, BLK,
                                           W, H, C, slope);
  } else {
    static_assert(!kLogit || kWindow, "the f32 walk rounds the logits in window layout only");
    f32_rowwalk<NV, kVec, kStats, kWindow, kLogit>(r, a_dst, a_src_win, x_ext, col, m_out, z_out, B,
                                           BLK, W, H, C, slope);
  }
}

template <int NV, bool kVec, bool kStats, bool kWindow, bool kBf16, bool kLogit>
int launch_rowwalk(const float* a_dst, const float* a_src_win, const RowT<kBf16>* x_ext,
                   const int* row_ptr, const int* col, const float* mean, float* out,
                   float* m_out, float* z_out, int B, int nB, int BLK, int W, int H, int C,
                   float slope, cudaStream_t stream) {
  const long long warps = (long long)B * nB * BLK;
  const size_t smem = (size_t)kWarps * 35 * min(H, kHeadGroup) * sizeof(float);
  band_rowwalk_kernel<NV, kVec, kStats, kWindow, kBf16, kLogit>
      <<<blocks_for(warps), kWarps * 32, smem, stream>>>(a_dst, a_src_win, x_ext, row_ptr, col,
                                                         mean, out, m_out, z_out, B, nB, BLK, W,
                                                         H, C, slope);
  return (int)cudaGetLastError();
}

// The row walk's instance for these operands: NV by H*C, the packed (float4,
// or bf16 quads) slots where vec.
template <bool kStats, bool kWindow, bool kBf16, bool kLogit = false>
int rowwalk_instance(const float* a_dst, const float* a_src_win, const RowT<kBf16>* x_ext,
                     const int* row_ptr, const int* col, const float* mean, float* out,
                     float* m_out, float* z_out, int B, int nB, int BLK, int W, int H, int C,
                     int vec, float slope, cudaStream_t s) {
  auto walk = H * C <= 128 ? (vec ? launch_rowwalk<1, true, kStats, kWindow, kBf16, kLogit>
                                  : launch_rowwalk<1, false, kStats, kWindow, kBf16, kLogit>)
                           : (vec ? launch_rowwalk<2, true, kStats, kWindow, kBf16, kLogit>
                                  : launch_rowwalk<2, false, kStats, kWindow, kBf16, kLogit>);
  return walk(a_dst, a_src_win, x_ext, row_ptr, col, mean, out, m_out, z_out, B, nB, BLK, W, H,
              C, slope, s);
}

// The whole forward: the window-mean pre-pass when the layout has rows with
// no set column (n_empty > 0; mean is then [B, nB, H*C] scratch), then the
// row walk. x_ext is f32, or bf16 when bf16 != 0 (the bf16-operand
// instance); bf16 & 2 (no statistics): the bf16 walk with the logits rounded
// as a layer with bf16 activations rounds them (logit_of<true>). kWindow: x_win
// is f32 and bf16 & 2 only rounds the logits (the v1 kernel of the JAX
// package, which such a layer reaches at H·C 128 and more through the
// window route, computes its weights and product in f32). vec != 0: C % 4 == 0 and x_ext, out 16-byte aligned (the
// wrapper checks). m_out, z_out are read only
// when kStats. kWindow: x_ext is x_win [nB, B, W, H, C] in f32; no
// statistics, and bf16 must be 0.
template <bool kStats, bool kWindow = false>
int band_rowwalk(const float* a_dst, const float* a_src_win, const void* x_ext,
                 const int* row_ptr, const int* col, const int* empty_ptr, float* mean,
                 float* out, float* m_out, float* z_out, int B, int nB, int BLK, int W,
                 int H, int C, int n_empty, int vec, int bf16, float slope, void* stream) {
  const long long warps = (long long)B * nB * BLK;
  if (warps == 0 || H * C == 0) return (int)cudaSuccess;
  static_assert(!(kWindow && kStats), "the window layout writes no statistics");
  cudaStream_t s = (cudaStream_t)stream;
  const int HC = H * C;
  const dim3 mean_grid((unsigned)((long long)B * nB), (unsigned)((HC + 31) / 32));
  if constexpr (!kWindow) {
    if (bf16) {
      const auto* xb = static_cast<const __nv_bfloat16*>(x_ext);
      if (n_empty > 0) {
        window_mean_bf16_kernel<<<mean_grid, kMeanWarps * 32, 0, s>>>(xb, empty_ptr, mean, nB,
                                                                     BLK, W, HC);
        const int rc = (int)cudaGetLastError();
        if (rc != 0) return rc;
      }
      if constexpr (!kStats) {
        if (bf16 & 2)                        // the logits rounded too (logit_of<true>)
          return rowwalk_instance<false, false, true, true>(a_dst, a_src_win, xb, row_ptr, col,
                                                            mean, out, m_out, z_out, B, nB, BLK,
                                                            W, H, C, vec, slope, s);
      }
      return rowwalk_instance<kStats, false, true>(a_dst, a_src_win, xb, row_ptr, col, mean, out,
                                                   m_out, z_out, B, nB, BLK, W, H, C, vec, slope,
                                                   s);
    }
  }
  const auto* xf = static_cast<const float*>(x_ext);
  if (n_empty > 0) {
    window_mean_kernel<kWindow><<<mean_grid, kMeanWarps * 32, 0, s>>>(xf, empty_ptr, mean, nB,
                                                                      BLK, W, HC);
    const int rc = (int)cudaGetLastError();
    if (rc != 0) return rc;
  }
  if constexpr (kWindow) {
    if (bf16 & 2)                          // the logits rounded (logit_of<true>), f32 weights
      return rowwalk_instance<false, true, false, true>(a_dst, a_src_win, xf, row_ptr, col,
                                                        mean, out, m_out, z_out, B, nB, BLK, W,
                                                        H, C, vec, slope, s);
  }
  return rowwalk_instance<kStats, kWindow, false>(a_dst, a_src_win, xf, row_ptr, col, mean, out,
                                                  m_out, z_out, B, nB, BLK, W, H, C, vec, slope,
                                                  s);
}

}  // namespace
