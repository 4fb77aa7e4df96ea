// GATConv's attention logit halves, forward and backward, for Hopper (sm_90a).
//
// For the projected rows xp [N, H, C] and the layer's att_src, att_dst
// [1, H, C]:
//
//   a_s[n, h] = sum_c xp[n, h, c] * att_src[h, c]
//   a_d[n, h] = sum_c xp[n, h, c] * att_dst[h, c]
//
// which the layer would otherwise compute as two multiplies that each write
// a whole [N, H, C] product and two reductions that read it back. The
// autograd Function (ops/gat_logits.py) passes xp through as an output, so
// its backward receives the projected rows' own cotangent d_out together
// with d a_s and d a_d and forms, in one pass,
//
//   d xp[n, h, c]     = d_out[n, h, c] + d_as[n, h] * att_src[h, c]
//                                      + d_ad[n, h] * att_dst[h, c]
//   d att_src[h, c]   = sum_n d_as[n, h] * xp[n, h, c]      (att_dst alike)
//
// Bound: bytes, about one FLOP a byte. The forward reads xp once and writes
// 2·N·H floats; the backward reads xp and d_out once and writes d xp once.
// The design:
// - forward: a group of G lanes per (n, h) segment of C channels, G the
//   power of two that covers C in float4 loads (C % 4 == 0 and 16-byte
//   aligned data) or in scalar loads (else), at most 32; a warp takes 32 / G
//   consecutive segments, so narrow layers (the zoo's C 32 and C 1) keep
//   every lane busy and every load coalesced. Each lane sums its channels in
//   ascending order, one fmaf each, then the group folds by a butterfly of
//   xor shuffles: a fixed order for a given C.
// - backward: a thread block of kThreads owns a column tile of TX units
//   (float4 or scalar) of the flattened H·C row and a chunk of rows; its TY
//   = kThreads / TX row groups take every TY-th row of the chunk,
//   kRowsPerGroup rows each, loading kUnroll rows before their FMAs. Each
//   thread keeps its columns' att values and d att partial sums in
//   registers; the row groups' partials fold in shared memory in a fixed
//   tree, and each chunk writes one partial row. A second launch folds the
//   chunks' partials, 32 stripes of ascending chunks and a fixed tree over
//   the stripes. No atomics: two runs give the same bits.
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 8;               // forward: warps a thread block
constexpr int kThreads = 256;           // backward: threads a thread block
constexpr int kRowsPerGroup = 16;       // backward: rows a row group takes in a chunk
constexpr int kUnroll = 4;              // backward: rows loaded before their FMAs
constexpr int kStripes = 32;            // fold: warps a thread block, each a stripe of chunks

// A unit of the flattened row: channels e .. e+3 as one float4 (kVec) or
// channel e in .x (the other three 0).
template <bool kVec>
__device__ __forceinline__ float4 load_unit(const float* __restrict__ p) {
  if constexpr (kVec) return __ldg(reinterpret_cast<const float4*>(p));
  return make_float4(__ldg(p), 0.f, 0.f, 0.f);
}

template <bool kVec>
__device__ __forceinline__ void store_unit(float* __restrict__ p, const float4& v) {
  if constexpr (kVec) *reinterpret_cast<float4*>(p) = v;
  else *p = v.x;
}

// acc += w * x, channel by channel (one fmaf each)
__device__ __forceinline__ void fma4(float w, const float4& x, float4& acc) {
  acc.x = fmaf(w, x.x, acc.x);
  acc.y = fmaf(w, x.y, acc.y);
  acc.z = fmaf(w, x.z, acc.z);
  acc.w = fmaf(w, x.w, acc.w);
}

__device__ __forceinline__ void add4(float4& acc, const float4& v) {
  acc.x += v.x;
  acc.y += v.y;
  acc.z += v.z;
  acc.w += v.w;
}

template <bool kVec>
__global__ void __launch_bounds__(kWarps * 32)
gat_logits_fwd_kernel(const float* __restrict__ xp,        // [N, H, C]
                      const float* __restrict__ att_src,   // [H, C]
                      const float* __restrict__ att_dst,   // [H, C]
                      float* __restrict__ a_s,             // [N, H]
                      float* __restrict__ a_d,             // [N, H]
                      long long segs, int H, int C, int G) {
  const int lane = threadIdx.x & 31;
  const long long first = ((long long)blockIdx.x * kWarps + (threadIdx.x >> 5)) * (32 / G);
  if (first >= segs) return;                     // the whole warp: no shuffle is left waiting
  const long long seg = first + lane / G;        // n·H + h
  const int g = lane & (G - 1);
  float ss = 0.f, sd = 0.f;
  if (seg < segs) {
    const float* xr = xp + seg * C;
    const long long h = seg % H;
    const float* as = att_src + h * C;
    const float* ad = att_dst + h * C;
    if constexpr (kVec) {
      for (int c = 4 * g; c < C; c += 4 * G) {
        const float4 x = load_unit<true>(xr + c), s = load_unit<true>(as + c),
                     d = load_unit<true>(ad + c);
        ss = fmaf(x.x, s.x, ss); ss = fmaf(x.y, s.y, ss); ss = fmaf(x.z, s.z, ss); ss = fmaf(x.w, s.w, ss);
        sd = fmaf(x.x, d.x, sd); sd = fmaf(x.y, d.y, sd); sd = fmaf(x.z, d.z, sd); sd = fmaf(x.w, d.w, sd);
      }
    } else {
      for (int c = g; c < C; c += G) {
        const float x = __ldg(xr + c);
        ss = fmaf(x, __ldg(as + c), ss);
        sd = fmaf(x, __ldg(ad + c), sd);
      }
    }
  }
  for (int o = G >> 1; o > 0; o >>= 1) {         // within the aligned group of G lanes
    ss += __shfl_xor_sync(kFull, ss, o);
    sd += __shfl_xor_sync(kFull, sd, o);
  }
  if (g == 0 && seg < segs) {
    a_s[seg] = ss;
    a_d[seg] = sd;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
gat_logits_bwd_kernel(const float* __restrict__ xp,        // [N, L]
                      const float* __restrict__ d_out,     // [N, L]
                      const float* __restrict__ d_as,      // [N, H]
                      const float* __restrict__ d_ad,      // [N, H]
                      const float* __restrict__ att_src,   // [L]
                      const float* __restrict__ att_dst,   // [L]
                      float* __restrict__ d_xp,            // [N, L]
                      float* __restrict__ part,            // [2, chunks, L]
                      int N, int H, int C, int TX) {
  const int L = H * C;
  const int TY = kThreads / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  const int e = (blockIdx.y * TX + tx) * (kVec ? 4 : 1);   // the column's first channel
  const bool live = e < L;
  const int h = live ? e / C : 0;
  const long long r0 = (long long)blockIdx.x * TY * kRowsPerGroup + ty;
  float4 acc_s = make_float4(0.f, 0.f, 0.f, 0.f), acc_d = acc_s;
  if (live) {
    const float4 s = load_unit<kVec>(att_src + e), d = load_unit<kVec>(att_dst + e);
    for (int i0 = 0; i0 < kRowsPerGroup; i0 += kUnroll) {
      float4 xv[kUnroll], gv[kUnroll];
      float ws[kUnroll], wd[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)TY * (i0 + u);
        if (r < N) {
          xv[u] = load_unit<kVec>(xp + r * L + e);
          gv[u] = load_unit<kVec>(d_out + r * L + e);
          ws[u] = __ldg(d_as + r * H + h);
          wd[u] = __ldg(d_ad + r * H + h);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long r = r0 + (long long)TY * (i0 + u);
        if (r < N) {
          const float4 dx = make_float4(fmaf(wd[u], d.x, fmaf(ws[u], s.x, gv[u].x)),
                                        fmaf(wd[u], d.y, fmaf(ws[u], s.y, gv[u].y)),
                                        fmaf(wd[u], d.z, fmaf(ws[u], s.z, gv[u].z)),
                                        fmaf(wd[u], d.w, fmaf(ws[u], s.w, gv[u].w)));
          store_unit<kVec>(d_xp + r * L + e, dx);
          fma4(ws[u], xv[u], acc_s);
          fma4(wd[u], xv[u], acc_d);
        }
      }
    }
  }
  __shared__ float4 sh[2][kThreads];
  sh[0][threadIdx.x] = acc_s;
  sh[1][threadIdx.x] = acc_d;
  __syncthreads();
  for (int st = TY >> 1; st > 0; st >>= 1) {     // row groups ty and ty + st, a fixed tree
    if (ty < st) {
      add4(sh[0][threadIdx.x], sh[0][threadIdx.x + st * TX]);
      add4(sh[1][threadIdx.x], sh[1][threadIdx.x + st * TX]);
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    const long long row = (long long)blockIdx.x * L + e;
    store_unit<kVec>(part + row, sh[0][tx]);
    store_unit<kVec>(part + (long long)gridDim.x * L + row, sh[1][tx]);
  }
}

// d att_src, d att_dst [L]: the chunks' partials summed, 32 columns a block;
// warp w sums chunks w, w + 32, ... in ascending order, and the 32 stripes
// fold in a fixed tree.
__global__ void __launch_bounds__(32 * kStripes)
gat_logits_fold_kernel(const float* __restrict__ part, float* __restrict__ d_att_src,
                       float* __restrict__ d_att_dst, int chunks, int L) {
  __shared__ float sh[kStripes][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;        // in [0, 2L): att_src's columns, then att_dst's
  float acc = 0.f;
  if (col < 2 * L) {
    const int which = col / L, e = col % L;
    const float* p = part + (long long)which * chunks * L + e;
    for (int k = w; k < chunks; k += kStripes) acc += __ldg(p + (long long)k * L);
  }
  sh[w][lane] = acc;
  __syncthreads();
  for (int st = kStripes >> 1; st > 0; st >>= 1) {
    if (w < st) sh[w][lane] += sh[w + st][lane];
    __syncthreads();
  }
  if (w == 0 && col < 2 * L) (col < L ? d_att_src[col] : d_att_dst[col - L]) = sh[0][lane];
}

// the smallest power of two at least n, at most cap
inline int pow2_cover(int n, int cap) {
  int p = 1;
  while (p < n && p < cap) p <<= 1;
  return p;
}

inline int bwd_tx(int H, int C, int vec) { return pow2_cover(vec ? H * C / 4 : H * C, kThreads); }

}  // namespace

// vec != 0: C % 4 == 0 and every pointer 16-byte aligned (the wrapper checks).
extern "C" int gat_logits_fwd(const float* xp, const float* att_src, const float* att_dst,
                              float* a_s, float* a_d, int N, int H, int C, int vec,
                              void* stream) {
  const long long segs = (long long)N * H;
  if (segs == 0) return (int)cudaSuccess;
  const int G = pow2_cover(vec ? (C + 3) / 4 : C, 32);
  const long long warps = (segs + 32 / G - 1) / (32 / G);
  auto kernel = vec ? gat_logits_fwd_kernel<true> : gat_logits_fwd_kernel<false>;
  kernel<<<(unsigned)((warps + kWarps - 1) / kWarps), kWarps * 32, 0, (cudaStream_t)stream>>>(
      xp, att_src, att_dst, a_s, a_d, segs, H, C, G);
  return (int)cudaGetLastError();
}

// The number of row chunks of the backward: the rows of the partials buffer
// [2, chunks, H·C] that the caller allocates.
extern "C" int gat_logits_bwd_chunks(int N, int H, int C, int vec) {
  const int rows = kThreads / bwd_tx(H, C, vec) * kRowsPerGroup;
  return (N + rows - 1) / rows;
}

extern "C" int gat_logits_bwd(const float* xp, const float* d_out, const float* d_as,
                              const float* d_ad, const float* att_src, const float* att_dst,
                              float* d_xp, float* part, float* d_att_src, float* d_att_dst,
                              int N, int H, int C, int vec, void* stream) {
  const int L = H * C;
  if (L == 0) return (int)cudaSuccess;
  const cudaStream_t st = (cudaStream_t)stream;
  const int TX = bwd_tx(H, C, vec);
  const int chunks = gat_logits_bwd_chunks(N, H, C, vec);
  if (chunks > 0) {
    const int units = vec ? L / 4 : L;
    auto kernel = vec ? gat_logits_bwd_kernel<true> : gat_logits_bwd_kernel<false>;
    kernel<<<dim3((unsigned)chunks, (unsigned)((units + TX - 1) / TX)), kThreads, 0, st>>>(
        xp, d_out, d_as, d_ad, att_src, att_dst, d_xp, part, N, H, C, TX);
  }
  gat_logits_fold_kernel<<<(unsigned)((2 * L + 31) / 32), 32 * kStripes, 0, st>>>(
      part, d_att_src, d_att_dst, chunks, L);
  return (int)cudaGetLastError();
}
