// The column walk of the band-attention backwards that take dp by extended
// row (csrc/band_bwd.cuh: v2's, v3's and, in window layout, v1's; and
// csrc/band_attention_flash_bwd.cu, v4), and the cells pass after it: one
// code, computed the same way for all. Per graph b and extended row e, over
// the mask entries k (band row g, window column j = e - blk*BLK) that read e,
// with p the entry's softmax weight per head, which a weights pass of the
// caller wrote as [B, nnz, H]:
//
//   d x_ext[b, e, h, :] = sum_k p_k dO[b, g, h, :]  (+ S of each covering
//                         block that holds padded rows)
//   dp[b, k, h]         = dO[b, g, h, :] . x_ext[b, e, h, :]
//
// and, once the caller has turned dp into dz [B, nnz, H],
//
//   d a_src_win[blk, b, j, h] = sum of dz over block blk's entries that read e
//
// In window layout (kWindow, v1) x and d x are [nB, B, W, H, C]: the sum
// above splits by covering block, d x_win[blk, b, j] = sum over block blk's
// entries of p dO (+ S of blk), and dp reads x_win[blk, b, j], the same
// values as x_ext[b, e] once the windows are cut from an extended array.
//
// columns: one warp per extended row e, all heads (in groups of kHeadGroup).
//          The lanes load the entries that read e (t_entry, t_row), one a
//          lane in one coalesced load, then their p for all heads; the
//          entries' rows go to the lanes by __shfl_sync and their dO rows, as
//          float4 slots, to shared memory by cp.async, up to stage_depth rows
//          at once, so no register holds them in flight and one round trip
//          brings a typical column's rows. d x_ext[e] stays in registers; dp
//          of each (entry, head) is the lanes' slot partials summed over the
//          lanes that hold that head's channels, written as [B, nnz, H]. When
//          C is a multiple of 128 each float4 row of lanes is one head, and a
//          group's four (entry, row) partials reduce together by a transposed
//          butterfly: 4 sums in 6 shuffles, not 20. Other C take a segmented
//          shuffle scan per entry and row. Both orders are fixed. In window
//          layout the warp takes the covering blocks in ascending order:
//          their entries are contiguous runs of t_ptr[e] .. t_ptr[e+1]. Per
//          block it loads x_win[blk, b, j] (where the run holds an entry),
//          sums the run, adds S of the block and writes d x_win[blk, b, j]
//          once, a zero row where the run is empty: each of the nB*W cells
//          of a graph has one owner, so the dense write needs no fill.
// cells:   one thread per (extended row e, head): d a_src_win of each block
//          whose window holds e, the sum of dz over the block's entries that
//          read e (sorted by row, so contiguous), 0 where there is none: every
//          cell written once.
//
// kBf16: the bf16-operand instance (the TPU kernels' mx = bfloat16, GATRes's
// attn_dtype): d x = sum bf16(p) bf16(dO) and dp = bf16(dO) . bf16(x),
// summed in f32 in the f32 instance's order. x_ext is the bf16 rows the bf16
// forwards gather (each x rounded once, when the rows were written): the
// warp loads its row as packed quads of 4 bf16, 8 bytes a lane a slot, in
// the f32 walk's channel layout (load_bf16_quads, csrc/band_common.cuh; its
// scalar variant where the f32 walk takes one), holds them packed and widens
// each, exactly, at the product. p and the staged f32 dO rows are rounded as
// they are read (operand<>; a dO slot two channels a conversion, staged<>).
// These are the operands of an instance that read f32 x and rounded it on
// load, in the same order, so the outputs are its bits. The S of padded rows
// stays f32. Bound: x_ext read at 2 bytes an element, dO at 4, d x_ext
// written at 4. dO stays f32: a bf16 copy written first costs its pass more
// than it saves the walk (PERF.md, tools/bf16_colwalk_variants.py).
//
// No atomics: every output element is written once and every sum is taken
// in a fixed order, so a run repeats to the bit.

#pragma once

#include <type_traits>

#include "band_common.cuh"

namespace {

constexpr int kHeadGroup = 8;            // heads of one pass: their state sits in shared memory
constexpr int kThreads = kWarps * 32;

// The bf16-operand instance's columns pass (kBf16) at NV 1 and NV 2: the dO
// rows it stages at once and the thread blocks an SM must hold.
// tools/bf16_colwalk_variants.py builds copies of this file with these
// rewritten.
constexpr int kBf16Depth[2] = {8, 6};
constexpr int kBf16MinBlocks[2] = {4, 3};

// entries of a chunk whose dO rows the columns pass stages at once: 8 rows of
// 128 channels or 6 of 256 (4 KB and 6 KB a warp); bf16: kBf16Depth
__host__ __device__ constexpr int stage_depth(int NV, bool bf16 = false) {
  return bf16 ? kBf16Depth[NV - 1] : NV == 1 ? 8 : 6;
}
// thread blocks an SM must hold for the columns pass: 4 (64 registers) at NV
// 1, 3 (80) at NV 2; bf16: kBf16MinBlocks
__host__ __device__ constexpr int columns_min_blocks(int NV, bool bf16 = false) {
  return bf16 ? kBf16MinBlocks[NV - 1] : NV == 1 ? 4 : 3;
}

// The element type of the x rows a columns instance reads: f32, or bf16 for
// the bf16-operand instance.
template <bool kBf16> struct XRow { using T = float; };
template <> struct XRow<true> { using T = __nv_bfloat16; };

__device__ __forceinline__ float leaky(float zpre, float slope) {
  return zpre >= 0.f ? zpre : slope * zpre;
}

// v summed over the lanes lo .. lane (lanes of one segment); the segment's
// last lane then holds its total. The order is fixed: a run repeats to the bit.
__device__ __forceinline__ float seg_scan(float v, int lane, int lo) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = __shfl_up_sync(kFull, v, o);
    if (lane - o >= lo) v += u;
  }
  return v;
}

// The segment of a lane in one row of lanes whose channels start at rb and
// step by `width` (4: a float4 slot; 1: a scalar): the lanes that hold
// channels of one head. Packed as head | first lane << 8 | last lane << 16;
// head hg past ce (those lanes hold nothing and add nothing).
__device__ __forceinline__ int segment_of(int rb, int width, int lane, int h0, int hg,
                                          int ce, int C) {
  const int c = rb + width * lane;
  if (c >= ce) return hg | lane << 8;
  const int hd = c / C - h0;
  const int lo = max(0, ((h0 + hd) * C - rb) / width);
  const int last = lane == 31 || (c + width) % C == 0;
  return hd | lo << 8 | last << 16;
}

// Adds a row of lanes' partial sums of one entry into dps[head] (that
// entry's dp per head), one segment at a time.
__device__ __forceinline__ void add_segments(float part, int seg, int lane, float* dps) {
  const float t = seg_scan(part, lane, (seg >> 8) & 0xff);
  if (seg >> 16) dps[seg & 0xff] += t;
  __syncwarp();                          // the next row's last lane may add to the same head
}

// The warp sums of a lane's V values (V a power of two, at most 32) by a
// transposed butterfly: each step keeps half the values and takes the other
// half's partner sums, so V sums cost V - 1 + log2(32 / V) shuffles, not
// 5 V. Lane l ends with the sum of value l >> (5 - log2 V), as do the other
// 32 / V lanes of its group. The order is fixed: a run repeats to the bit.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&val)[V], int lane) {
#pragma unroll
  for (int n = V, o = 16; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i) {
      const float keep = up ? val[i + n / 2] : val[i];
      const float send = up ? val[i] : val[i + n / 2];
      val[i] = keep + __shfl_xor_sync(kFull, send, o);
    }
  }
  float r = val[0];
#pragma unroll
  for (int o = 32 / V / 2; o > 0; o >>= 1) r += __shfl_xor_sync(kFull, r, o);
  return r;
}

// One lane's slot of an x-like row of n floats, copied to shared memory by
// cp.async (no register holds it in flight): as load_slot, the float4 at c
// (kVec), else the floats at c, c+32, c+64, c+96; zeros past n.
template <bool kVec>
__device__ __forceinline__ void stage_slot(float4* dst, const float* __restrict__ xr, int c, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (kVec) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(c < n ? xr + c : xr), "r"(c < n ? 16 : 0));
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cj = c + 32 * j;
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d + 4 * j),
                   "l"(cj < n ? xr + cj : xr), "r"(cj < n ? 4 : 0));
    }
  }
}

__device__ __forceinline__ void stage_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// A staged dO slot as the product reads it: an f32 slot, rounded to bf16 in
// the bf16-operand instance two channels a conversion (cvt.rn.bf16x2.f32;
// the values of one conversion a channel, in fewer instructions).
template <bool kBf16>
__device__ __forceinline__ float4 staged(float4 s) {
  if constexpr (kBf16) {
    return bf16_quad(bf16_pack4(s));
  } else {
    return s;
  }
}

// x_ext[e]'s slot as the product reads it: f32, or a packed bf16 quad widened
__device__ __forceinline__ float4 x_value(float4 v) { return v; }
__device__ __forceinline__ float4 x_value(uint2 q) { return bf16_quad(q); }

// The end of the run of block blk's entries that starts at s: the entries
// s .. t1-1 of an extended row are sorted by block, so those of blocks up to
// blk are a prefix (a ballot over 32 at a time).
__device__ __forceinline__ int run_end(const int* __restrict__ t_row, int s, int t1, int blk,
                                       int BLK, int lane) {
  for (;; s += 32) {
    const int t = s + lane;
    const int n = __popc(__ballot_sync(kFull, t < t1 && t_row[t] / BLK <= blk));
    if (n < 32) return s + n;
  }
}

// kWhole: kVec and C % 128 == 0, so each row of lanes (a float4 slot of the
// tile) holds channels of one head, and the dp partials of a group of
// entries reduce together (reduce_scatter); else a segmented scan per entry
// and row (add_segments). columns_min_blocks(NV) caps the registers (64 at
// NV 1, 80 at NV 2, where a lane holds two float4 of x_ext[e] and of its sums).
// kWindow: x_op and d_x_op in window layout, one run of entries per covering block.
// kBf16: x_op in bf16, p and dO rounded to bf16 as they are read.
template <int NV, bool kVec, bool kWhole, bool kWindow, bool kBf16>
__global__ void __launch_bounds__(kThreads, columns_min_blocks(NV, kBf16))
columns_kernel(const typename XRow<kBf16>::T* __restrict__ x_op,   // x_ext; kWindow x_win
               const float* __restrict__ dout,      // [B, n_pad, H, C]
               const float* __restrict__ p_in,      // [B, nnz, H]
               const float* __restrict__ S,         // [B, nB, H, C] or null
               const int* __restrict__ t_ptr,       // [n_ext + 1]
               const int* __restrict__ t_entry,     // [nnz]
               const int* __restrict__ t_row,       // [nnz]
               const int* __restrict__ empty_ptr,   // [nB + 1]
               float* __restrict__ dp_out,          // [B, nnz, H]
               float* __restrict__ d_x_op,          // d x_ext; kWindow d x_win [nB, B, W, H, C]
               int B, int nB, int BLK, int W, int H, int C, int nnz) {
  static_assert(!(kWindow && kBf16), "the window layout has no bf16-operand instance");
  using XV = std::conditional_t<kBf16, uint2, float4>;   // x_ext[e]'s slot: kBf16 a packed quad
  // per warp: the staged dO slots [kDepth][NV][32] float4, then p, dp [32][G]
  extern __shared__ float4 smem4[];
  constexpr int kTile = 128 * NV;
  constexpr int kDepth = stage_depth(NV, kBf16);
  constexpr int kSlots4 = kDepth * NV * 32;   // float4s of a warp's slots
  constexpr int kA = 4 / NV;             // entries whose partials reduce together
  constexpr int kRows = kVec ? NV : 4 * NV;   // rows of lanes a tile: one per slot or element
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5;
  const long long warp = (long long)blockIdx.x * kWarps + wib;
  const int n_pad = nB * BLK;
  const int n_ext = n_pad + W - BLK;
  if (warp >= (long long)B * n_ext) return;
  const int e = (int)(warp % n_ext);
  const int b = (int)(warp / n_ext);
  const int HC = H * C;

  const int t0 = t_ptr[e], t1 = t_ptr[e + 1];
  // blocks whose window [blk*BLK, blk*BLK + W) holds e; lane q asks whether
  // block blk_lo + q holds padded rows (loaded here, used at the end; blocks
  // past 32 are asked in turn; kWindow asks block by block)
  const int blk_hi = min(nB - 1, e / BLK);
  const int blk_lo = e >= W ? (e - W) / BLK + 1 : 0;
  const bool asks = !kWindow && S != nullptr && blk_lo + lane <= blk_hi;
  const int e0 = asks ? empty_ptr[blk_lo + lane] : 0, e1 = asks ? empty_ptr[blk_lo + lane + 1] : 0;
  const int G = min(H, kHeadGroup);
  float4* stage = smem4 + wib * kSlots4 + lane;   // the lane's: stride 32
  float* p_sh = reinterpret_cast<float*>(smem4 + kWarps * kSlots4) + wib * 64 * G;
  float* dp_sh = p_sh + 32 * G;
  const float* pb = p_in + (long long)b * nnz * H;
  float* dpb = dp_out + (long long)b * nnz * H;
  const float* dbase = dout + (long long)b * n_pad * HC;
  const auto* xe = x_op + ((long long)b * n_ext + e) * HC;   // not kWindow: the warp's rows
  float* dxe = d_x_op + ((long long)b * n_ext + e) * HC;

  for (int h0 = 0; h0 < H; h0 += G) {
    const int hg = min(G, H - h0);           // heads h0 .. h0+hg-1, channels up to ce
    const int ce = (h0 + hg) * C;
    for (int c0 = h0 * C; c0 < ce; c0 += kTile) {
      const bool first = c0 == h0 * C;
      XV xv[NV];                            // kBf16: x_ext[e]'s quads, packed
      float4 acc[NV];
      // the group's head of each of the lane's channels: one a float4 slot, or
      // one a scalar (0 past ce: loads give 0 there and stores skip)
      int head[NV][kVec ? 1 : 4];
      int seg[kWhole ? 1 : kRows];
#pragma unroll
      for (int v = 0; v < NV; ++v) {
        if constexpr (!kBf16)
          if (!kWindow)
            xv[v] = load_slot<kVec>(xe, kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane, ce);
        acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kWhole) {
          head[v][0] = min(c0 + 128 * v, ce - 1) / C - h0;   // the row's head, lane-uniform
        } else if (kVec) {
          const int c = c0 + 128 * v + 4 * lane;
          head[v][0] = c < ce ? c / C - h0 : 0;
          seg[v] = segment_of(c0 + 128 * v, 4, lane, h0, hg, ce, C);
        } else {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int c = c0 + 128 * v + 32 * j + lane;
            head[v][kVec ? 0 : j] = c < ce ? c / C - h0 : 0;
            seg[4 * v + j] = segment_of(c0 + 128 * v + 32 * j, 1, lane, h0, hg, ce, C);
          }
        }
      }
      if constexpr (kBf16) {                 // x_ext[e]'s tile: NV quads of 4 bf16
        load_bf16_quads<NV, kVec>(xe, c0, lane, ce, xv);
      }

      auto add_s = [&](int blk) {            // S of a covering block with padded rows
        const float* sr = S + ((long long)b * nB + blk) * HC;
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          const float4 s =
              load_slot<kVec>(sr, kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane, ce);
          acc[v].x += s.x;
          acc[v].y += s.y;
          acc[v].z += s.z;
          acc[v].w += s.w;
        }
      };
      auto store = [&](float* row) {         // the tile of acc into a d x row
#pragma unroll
        for (int v = 0; v < NV; ++v) {
          if (kVec) {
            const int c = c0 + 128 * v + 4 * lane;
            if (c < ce) *reinterpret_cast<float4*>(row + c) = acc[v];
          } else {
            const int c = c0 + 128 * v + lane;
            if (c < ce) row[c] = acc[v].x;
            if (c + 32 < ce) row[c + 32] = acc[v].y;
            if (c + 64 < ce) row[c + 64] = acc[v].z;
            if (c + 96 < ce) row[c + 96] = acc[v].w;
          }
        }
      };
      // the entries r_lo .. r_hi-1 into acc, their dp against xv, and acc into
      // its d x row: all of e's entries and d x_ext[e] in one run, or kWindow
      // one run per covering block in ascending order, each with its x_win
      // and d x_win rows [blk, b, e - blk*BLK] and its S
      for (int blk = blk_lo, s = t0;; ++blk) {
        int r_lo = t0, r_hi = t1;
        long long cell = 0;
        if (kWindow) {
          r_lo = s;
          r_hi = run_end(t_row, s, t1, blk, BLK, lane);
          cell = ((long long)blk * B + b) * W + e - (long long)blk * BLK;
          if constexpr (!kBf16)
            if (r_hi > r_lo)                 // uniform: the run has entries, so dp needs x
#pragma unroll
              for (int v = 0; v < NV; ++v)
                xv[v] = load_slot<kVec>(x_op + cell * HC,
                                        kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane, ce);
        }
        for (int s0 = r_lo; s0 < r_hi; s0 += 32) {   // one chunk of the entries that read e
          const int t = s0 + lane;
          const bool on = t < r_hi;
          const int g = on ? t_row[t] : 0;
          const int k = on ? t_entry[t] : 0;
          const int cnt = min(32, r_hi - s0);
          for (int r0 = 0; r0 < cnt; r0 += kDepth) {   // up to kDepth entries' dO rows in flight
            const int n = min(kDepth, cnt - r0);
            for (int q = 0; q < n; ++q) {
              const float* dr = dbase + __shfl_sync(kFull, g, r0 + q) * HC;
#pragma unroll
              for (int v = 0; v < NV; ++v)
                stage_slot<kVec>(stage + (q * NV + v) * 32, dr,
                                 kVec ? c0 + 128 * v + 4 * lane : c0 + 128 * v + lane, ce);
            }
            if (r0 == 0) {                       // the weights load while the rows arrive
              for (int h = 0; h < hg; ++h) {
                p_sh[lane * G + h] = on ? operand<kBf16>(pb[(long long)k * H + h0 + h]) : 0.f;
                dp_sh[lane * G + h] = 0.f;
              }
              __syncwarp();
            }
            stage_wait();                        // the lane reads back only its own slots
            for (int gq = 0; gq < n; gq += kA) {
              float val[kA * NV];                // kWhole: the group's partials of dp
#pragma unroll
              for (int q = 0; q < kA; ++q) {
                const int qq = min(gq + q, n - 1);   // past n: a repeat, not added
                const bool live = gq + q < n;        // uniform across the warp
                const float* ps = p_sh + (r0 + qq) * G;
#pragma unroll
                for (int v = 0; v < NV; ++v) {
                  const float4 a = staged<kBf16>(stage[(qq * NV + v) * 32]), x = x_value(xv[v]);
                  if (live) {
                    acc[v].x = fmaf(ps[head[v][0]], a.x, acc[v].x);
                    acc[v].y = fmaf(ps[head[v][kVec ? 0 : 1]], a.y, acc[v].y);
                    acc[v].z = fmaf(ps[head[v][kVec ? 0 : 2]], a.z, acc[v].z);
                    acc[v].w = fmaf(ps[head[v][kVec ? 0 : 3]], a.w, acc[v].w);
                  }
                  if (kWhole) {
                    val[q * NV + v] = fmaf(a.w, x.w, fmaf(a.z, x.z, fmaf(a.y, x.y, a.x * x.x)));
                  } else if (live) {
                    float* dps = dp_sh + (r0 + qq) * G;
                    if (kVec) {
                      add_segments(fmaf(a.w, x.w, fmaf(a.z, x.z, fmaf(a.y, x.y, a.x * x.x))),
                                   seg[v], lane, dps);
                    } else {
                      add_segments(a.x * x.x, seg[4 * v], lane, dps);
                      add_segments(a.y * x.y, seg[4 * v + 1], lane, dps);
                      add_segments(a.z * x.z, seg[4 * v + 2], lane, dps);
                      add_segments(a.w * x.w, seg[4 * v + 3], lane, dps);
                    }
                  }
                }
              }
              if (kWhole) {
                const float r = reduce_scatter<kA * NV>(val, lane);
                const int idx = lane >> 3;                     // kA * NV == 4 sums
                const int q = idx / NV, v = idx % NV;
#pragma unroll
                for (int w = 0; w < NV; ++w) {   // two rows may be one head: they add in turn
                  if (v == w && (lane & 7) == 0 && gq + q < n)
                    dp_sh[(r0 + gq + q) * G + head[v][0]] += r;
                  __syncwarp();
                }
              }
            }
          }
          // the lane's entry's dp, this tile's part (the same lane owns it in every tile)
          if (on)
            for (int h = 0; h < hg; ++h) {
              float* d = dpb + (long long)k * H + h0 + h;
              *d = first ? dp_sh[lane * G + h] : *d + dp_sh[lane * G + h];
            }
          __syncwarp();                        // p_sh, dp_sh are read before the next chunk writes them
        }
        if (kWindow) {
          if (S != nullptr && empty_ptr[blk] != empty_ptr[blk + 1]) add_s(blk);
          store(d_x_op + cell * HC);
#pragma unroll
          for (int v = 0; v < NV; ++v) acc[v] = make_float4(0.f, 0.f, 0.f, 0.f);
          s = r_hi;
          if (blk == blk_hi) break;
        } else {
          for (unsigned bits = __ballot_sync(kFull, e0 != e1); bits; bits &= bits - 1)
            add_s(blk_lo + __ffs(bits) - 1);
          if (S != nullptr)                    // a window of more than 32 blocks: the rest in turn
            for (int bq = blk_lo + 32; bq <= blk_hi; ++bq)
              if (empty_ptr[bq] != empty_ptr[bq + 1]) add_s(bq);
          store(dxe);
          break;
        }
      }
    }
  }
}

// d a_src_win: one thread per (b, extended row e, head), h fastest; the
// cells of every block whose window holds e, one block after the other.
__global__ void __launch_bounds__(kThreads)
cells_kernel(const float* __restrict__ dz_in,     // [B, nnz, H]
             const int* __restrict__ t_ptr,       // [n_ext + 1]
             const int* __restrict__ t_entry,     // [nnz]
             const int* __restrict__ t_row,       // [nnz]
             float* __restrict__ d_a_src_win,     // [nB, B, W, H]
             int B, int nB, int BLK, int W, int H, int nnz) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long n_ext = (long long)nB * BLK + W - BLK;
  if (i >= (long long)B * n_ext * H) return;
  const int h = (int)(i % H);
  const long long e = (i / H) % n_ext;
  const long long b = i / H / n_ext;
  const int t1 = t_ptr[e + 1];
  const int blk_hi = (int)min((long long)nB - 1, e / BLK);
  const int blk_lo = e >= W ? (int)((e - W) / BLK + 1) : 0;
  const float* dzb = dz_in + b * (long long)nnz * H + h;
  float* cell = d_a_src_win + (b * W + e) * H + h;     // block blk's cell: cell[blk * step]
  const long long step = ((long long)B * W - BLK) * H;
  int blk = blk_lo;
  float acc = 0.f;
#pragma unroll 4
  for (int t = t_ptr[e]; t < t1; ++t) {    // the entries come by block, in row order
    const int bt = t_row[t] / BLK;
    const float v = dzb[(long long)t_entry[t] * H];
    for (; blk < bt; ++blk, acc = 0.f) cell[blk * step] = acc;
    acc += v;
  }
  for (; blk <= blk_hi; ++blk, acc = 0.f) cell[blk * step] = acc;
}

inline unsigned threads_for(long long n) { return (unsigned)((n + kThreads - 1) / kThreads); }

template <int NV, bool kVec, bool kWhole, bool kWindow, bool kBf16>
int launch_columns(const typename XRow<kBf16>::T* x, const float* dout, const float* p,
                   const float* S, const int* t_ptr, const int* t_entry, const int* t_row,
                   const int* empty_ptr, float* dp, float* d_x, int B, int nB, int BLK, int W,
                   int H, int C, int nnz, cudaStream_t st) {
  const long long n_ext = (long long)nB * BLK + W - BLK;
  const size_t smem = (size_t)kWarps * (stage_depth(NV, kBf16) * NV * 32 * sizeof(float4) +
                                        64 * min(H, kHeadGroup) * sizeof(float));
  auto kernel = columns_kernel<NV, kVec, kWhole, kWindow, kBf16>;
  if (smem > (48 << 10)) {                 // past the default 48 KB of dynamic shared memory
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<blocks_for((long long)B * n_ext), kThreads, smem, st>>>(
      x, dout, p, S, t_ptr, t_entry, t_row, empty_ptr, dp, d_x, B, nB, BLK, W, H, C, nnz);
  return (int)cudaGetLastError();
}

// The columns pass's instance for these operands: channel tiles sized to the
// head group's channels, 128 (one float4 a lane) when G*C <= 128, else 256,
// so a group of H*C 128 wastes no half tile; the butterfly where a float4
// slot row is one head. vec: C % 4 == 0 and x, dout 16-byte aligned.
// kWindow: x and d_x are x_win and d x_win [nB, B, W, H, C]. kBf16: the
// bf16-operand instance, x in bf16.
template <bool kWindow = false, bool kBf16 = false>
int columns_pass(int vec, const typename XRow<kBf16>::T* x, const float* dout, const float* p,
                 const float* S, const int* t_ptr, const int* t_entry, const int* t_row,
                 const int* empty_ptr, float* dp, float* d_x, int B, int nB, int BLK, int W, int H,
                 int C, int nnz, cudaStream_t st) {
  const bool narrow = min(H, kHeadGroup) * C <= 128;   // one float4 a lane fills the tile
  const bool whole = vec && C % 128 == 0;              // a float4 slot row is one head
  auto columns = narrow ? (whole ? launch_columns<1, true, true, kWindow, kBf16>
                                 : vec ? launch_columns<1, true, false, kWindow, kBf16>
                                       : launch_columns<1, false, false, kWindow, kBf16>)
                        : (whole ? launch_columns<2, true, true, kWindow, kBf16>
                                 : vec ? launch_columns<2, true, false, kWindow, kBf16>
                                       : launch_columns<2, false, false, kWindow, kBf16>);
  return columns(x, dout, p, S, t_ptr, t_entry, t_row, empty_ptr, dp, d_x, B, nB, BLK, W, H, C,
                 nnz, st);
}

}  // namespace
