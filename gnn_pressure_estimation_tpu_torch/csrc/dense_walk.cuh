// The walk of the dense-mode factored aggregation, forward and backward
// (csrc/fused_factored.cu, csrc/fused_factored_bwd.cu): one function. Per
// graph b and node u, over the entries w of u's list in the mask index, with
// the 0/1 gate p = [own[b, u, h] + other[b, w, h] >= 0] (one f32 add):
//
//   out_pos[b, u, h, :] = sum_w p       x_pos[b, w, h, :]
//   out_neg[b, u, h, :] = sum_w (1 - p) x_neg[b, w, h, :]
//
// Forward: u = i over the row lists (MaskIndex row_ptr, col), own = a_dst,
// other = a_src, x = rhs_v / rhs_q, out = t_pv / t_nq. Backward: u = j over
// the column lists (t_ptr, t_row), own = a_src, other = a_dst, x = g_pv /
// g_nq, out = d rhs_v / d rhs_q. f32 addition commutes to the bit, so both
// directions form the same gate as a_dst + a_src. All operands are f32 in
// the layer's layout: own, other [B, n, H]; x, out [B, n, H, D], D = C + 1.
//
// Bound: bytes. The work is D adds per set cell and head on a mask about 1%
// dense (1,782 set cells of 150,544 on synthctown): about 0.25 FLOP a byte.
// Tensor cores over dense n x n tiles would do ~85x the useful work, and
// their TF32 inputs would break the 1e-4 gate against the plain version, so
// wgmma and TMA do not apply. No row is reused within a warp, so nothing is
// staged in shared memory. At B 32 all of x_pos and x_neg fits the 50 MB L2
// (25.6 MB at H 2, D 129), so the bound counts each array once. What sets
// the time at the small widths is latency: each list is a chain of dependent
// loads (the list's bounds, its indices, the other node's gate terms, then
// the x rows); at H*D 258 the time grows with the bytes, each row gathered
// from L2 by ~4.6 neighbours. What the design does about it:
// - one warp per (b, u), all heads: u's H*D channels are contiguous, so the
//   warp reads the list and own[b, u, :] once, not once a head. A lane owns
//   NE channels of a tile, 32 apart; the head of each (c / D) is worked out
//   once a tile, as its bit in the gate word;
// - the list in chunks of 32 entries, one a lane: one coalesced load of the
//   indices, then each lane forms its entry's gate bits for up to 32 heads
//   (kGateHeads; more heads run in groups) in one word, and the warp reads
//   entry s's index and word by __shfl_sync. The first chunk's indices and
//   words stay in registers for every channel tile;
// - loads ahead: the x rows of the next kAhead entries (kFloatsAhead / NE,
//   at least one) are all in flight before their adds. Each element loads
//   from x_pos or from x_neg by its head's bit: one load, not two;
// - channel tiles of at most kMaxTile channels: the widest head group's
//   channels spread evenly over as few tiles as that allows (H*D 66: one
//   tile, NE 3; H*D 258: two of 160 and 98, NE 5); each tile walks the list;
// - the sums of a walk that takes one (b, u, h) at a time: per channel the
//   adds go in list order into an accumulator that starts at +0 (so it never
//   holds -0, and an add skipped equals an add of 0), and each output element
//   is written once, by one warp. No atomics: a run repeats to the bit.
// Registers: at most 64 (kDenseMinBlocks blocks of kDenseWarps warps an SM);
// the instances the GATRes convs use (NE 2, 3, 5) do not spill. On an H100
// SXM (NVIDIA H100 80GB HBM3, 700 W) at synthctown B 32: 12.5 us at H*D 66
// (bound 4.0), 33.9 us at H*D 258 (bound 15.4), forward and backward alike.

#pragma once

#include "band_common.cuh"

namespace {

constexpr int kGateHeads = 32;          // heads of one pass over the list: one gate word
constexpr int kDenseWarps = 4;          // warps per thread block
constexpr int kDenseMinBlocks = 8;      // thread blocks an SM must hold: <= 64 registers
constexpr int kFloatsAhead = 8;         // floats of x rows a lane loads before their adds
constexpr int kMaxTile = 256;           // channels of one pass over the list

struct DenseWalk {
  const float* own;       // [B, n, H]   the warp's node's gate term
  const float* other;     // [B, n, H]   the listed nodes' gate terms
  const float* x_pos;     // [B, n, H, D]
  const float* x_neg;     // [B, n, H, D]
  const int* ptr;         // [n + 1]     entries of node u: ptr[u] .. ptr[u + 1]
  const int* idx;         // [nnz]       the listed node of each entry
  float* out_pos;         // [B, n, H, D]
  float* out_neg;         // [B, n, H, D]
  int B, n, H, D;
};

// The lane's entry k of the chunk (k < k1) and its gate word: bit h set when
// own[h0 + h] + other[w, h0 + h] >= 0, for the hg heads of the group.
__device__ __forceinline__ void gate_chunk(const DenseWalk& a, const float* ow, const float* ot,
                                           int h0, int hg, int k, int k1, int& w, unsigned& word) {
  w = 0;
  word = 0u;
  if (k < k1) {
    w = __ldg(a.idx + k);
    const float* t = ot + (long long)w * a.H + h0;
#pragma unroll 4
    for (int h = 0; h < hg; ++h)
      word |= (__ldg(ow + h0 + h) + __ldg(t + h) >= 0.f ? 1u : 0u) << h;
  }
}

// NE elements a lane in a tile of 32 NE channels: channel c0 + 32 e + lane.
template <int NE>
__global__ void __launch_bounds__(kDenseWarps * 32, kDenseMinBlocks)
dense_walk_kernel(const DenseWalk a) {
  constexpr int kAhead = kFloatsAhead / NE > 1 ? kFloatsAhead / NE : 1;
  constexpr int kTile = 32 * NE;
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kDenseWarps + (threadIdx.x >> 5);
  if (warp >= (long long)a.B * a.n) return;
  const long long u = warp % a.n, b = warp / a.n;
  const int HD = a.H * a.D;                                // n * HD < 2^31 (the launcher checks)
  const float* ow = a.own + warp * a.H;                    // warp == b * n + u
  const float* ot = a.other + b * a.n * a.H;
  const float* xp = a.x_pos + b * a.n * HD;
  const float* xn = a.x_neg + b * a.n * HD;
  float* op = a.out_pos + warp * HD;
  float* on = a.out_neg + warp * HD;
  const int k0 = a.ptr[u], k1 = a.ptr[u + 1];

  for (int h0 = 0; h0 < a.H; h0 += kGateHeads) {
    const int hg = min(kGateHeads, a.H - h0);
    const int ce = (h0 + hg) * a.D;                        // the group's channels: [h0*D, ce)
    int w_first;
    unsigned word_first;
    gate_chunk(a, ow, ot, h0, hg, k0 + lane, k1, w_first, word_first);

    for (int c0 = h0 * a.D; c0 < ce; c0 += kTile) {
      unsigned hbit[NE];                                   // the element's head's bit; 0 past ce
      float accp[NE], accn[NE];
#pragma unroll
      for (int e = 0; e < NE; ++e) {
        const int c = c0 + 32 * e + lane;
        hbit[e] = c < ce ? 1u << (c / a.D - h0) : 0u;
        accp[e] = accn[e] = 0.f;
      }

      for (int s0 = k0; s0 < k1; s0 += 32) {             // one chunk of the list
        int wl = w_first;
        unsigned wordl = word_first;
        if (s0 != k0) gate_chunk(a, ow, ot, h0, hg, s0 + lane, k1, wl, wordl);
        const int cnt = min(32, k1 - s0);
        for (int g = 0; g < cnt; g += kAhead) {
          float x[kAhead][NE];
          unsigned word[kAhead];
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            const int s = min(g + q, cnt - 1);
            const int row = __shfl_sync(kFull, wl, s) * HD;
            word[q] = __shfl_sync(kFull, wordl, s);
            if (g + q < cnt) {                             // uniform over the warp
#pragma unroll
              for (int e = 0; e < NE; ++e)
                if (hbit[e])
                  x[q][e] = __ldg((word[q] & hbit[e] ? xp : xn) + row + c0 + 32 * e + lane);
            }
          }
#pragma unroll
          for (int q = 0; q < kAhead; ++q) {
            if (g + q < cnt) {
#pragma unroll
              for (int e = 0; e < NE; ++e)
                if (hbit[e]) {
                  if (word[q] & hbit[e]) accp[e] += x[q][e];
                  else accn[e] += x[q][e];
                }
            }
          }
        }
      }

#pragma unroll
      for (int e = 0; e < NE; ++e)
        if (hbit[e]) {
          op[c0 + 32 * e + lane] = accp[e];
          on[c0 + 32 * e + lane] = accn[e];
        }
    }
  }
}

template <int NE>
int launch_dense_walk(const DenseWalk& a, cudaStream_t stream) {
  const long long warps = (long long)a.B * a.n;
  dense_walk_kernel<NE><<<(unsigned)((warps + kDenseWarps - 1) / kDenseWarps), kDenseWarps * 32,
                          0, stream>>>(a);
  return (int)cudaGetLastError();
}

// The instance of ne elements a lane, ne <= NE.
template <int NE>
int dense_walk_ne(const DenseWalk& a, int ne, cudaStream_t stream) {
  if constexpr (NE > 1)
    if (ne < NE) return dense_walk_ne<NE - 1>(a, ne, stream);
  return launch_dense_walk<NE>(a, stream);
}

// The whole walk: the widest head group's channels spread evenly over as few
// tiles of at most kMaxTile as that allows.
inline int dense_walk(const DenseWalk& a, void* stream) {
  if ((long long)a.B * a.n == 0 || a.H * a.D == 0) return (int)cudaSuccess;
  if ((long long)a.n * a.H * a.D > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const int gw = min(a.H, kGateHeads) * a.D;
  const int tiles = (gw + kMaxTile - 1) / kMaxTile;
  const int per = (gw + tiles - 1) / tiles;
  return dense_walk_ne<kMaxTile / 32>(a, (per + 31) / 32, (cudaStream_t)stream);
}

}  // namespace
