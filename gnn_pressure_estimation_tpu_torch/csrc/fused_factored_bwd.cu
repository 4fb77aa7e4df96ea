// Fused factored aggregation of dense-mode GAT, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_fused_factored in
// gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py (bwd_kernel).
// With the 0/1 gate P_ij = M_ij [a_dst[b,i,h] + a_src[b,j,h] >= 0]
// (recomputed: one f32 add, >=) and g_pv, g_nq the cotangents of the
// forward's two outputs:
//
//   d rhs_v[b,j,h,:] = sum_i P_ij g_pv[b,i,h,:]
//   d rhs_q[b,j,h,:] = sum_i (M_ij - P_ij) g_nq[b,i,h,:]
//
// The gate is a comparison: a_dst and a_src get no cotangent.
//
// Both sums scatter by column. The kernel walks the transposed index instead
// (MaskIndex: the set cells sorted by column, with their rows): one warp per
// (b, j, h) reads one row of g_pv or of g_nq per set cell of column j, the
// channels over its lanes, and writes each output row once. No atomics, so a
// run repeats to the bit. The mask need not be symmetric.
//
// Bound: bytes (g_pv and g_nq read once between them per set cell's row,
// both outputs written once).
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per thread block
constexpr int kPerLane = 8;             // channels per lane in one tile
constexpr int kTile = 32 * kPerLane;    // channels per tile

__global__ void __launch_bounds__(kWarps * 32)
fused_factored_bwd_kernel(const float* __restrict__ a_dst,   // [B, n, H]
                          const float* __restrict__ a_src,   // [B, n, H]
                          const float* __restrict__ g_pv,    // [B, n, H, D]
                          const float* __restrict__ g_nq,    // [B, n, H, D]
                          const int* __restrict__ t_ptr,     // [n + 1]
                          const int* __restrict__ t_row,     // [nnz]
                          float* __restrict__ d_rv,          // [B, n, H, D]
                          float* __restrict__ d_rq,          // [B, n, H, D]
                          int B, int n, int H, int D) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * n * H) return;
  const int h = (int)(warp % H);
  const long long j = (warp / H) % n;
  const long long b = warp / H / n;
  const long long HD = (long long)H * D;

  const int t0 = t_ptr[j], t1 = t_ptr[j + 1];
  const float as = a_src[(b * n + j) * H + h];
  const float* ad = a_dst + b * n * H + h;
  const long long base = b * n * HD + (long long)h * D;   // of node 0, head h
  const long long orow = base + j * HD;

  for (int c0 = 0; c0 < D; c0 += kTile) {
    float accv[kPerLane], accq[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) accv[q] = accq[q] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const long long i = t_row[t];
      const float s = ad[i * H] + as;
      if (s >= 0.f) {
        const float* r = g_pv + base + i * HD + c0;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c0 + c < D) accv[q] += __ldg(r + c);
        }
      } else {
        const float* r = g_nq + base + i * HD + c0;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c0 + c < D) accq[q] += __ldg(r + c);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < D) {
        d_rv[orow + c0 + c] = accv[q];
        d_rq[orow + c0 + c] = accq[q];
      }
    }
  }
}

}  // namespace

extern "C" int fused_factored_bwd(const float* a_dst, const float* a_src,
                                  const float* g_pv, const float* g_nq,
                                  const int* t_ptr, const int* t_row,
                                  float* d_rv, float* d_rq, int B, int n,
                                  int H, int D, void* stream) {
  const long long warps = (long long)B * n * H;
  if (warps == 0 || D == 0) return (int)cudaSuccess;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  fused_factored_bwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                              (cudaStream_t)stream>>>(
      a_dst, a_src, g_pv, g_nq, t_ptr, t_row, d_rv, d_rq, B, n, H, D);
  return (int)cudaGetLastError();
}
