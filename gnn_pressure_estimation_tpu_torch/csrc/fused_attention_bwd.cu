// Fused dense-mode GAT attention, backward, for Hopper (sm_90a).
//
// Replaces the backward of make_fused_attention in
// gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py (bwd_kernel).
// With z_ij = a_dst[b,i,h] + a_src[b,j,h] (one f32 add), p the row softmax of
// LeakyReLU(z) over the set cells of mask row i (recomputed: the forward
// saves nothing but its inputs) and dO the cotangent of the forward's output:
//
//   dp_ij        = dO[b,i,h,:] . v[b,j,h,:]
//   dz_ij        = p_ij (dp_ij - sum_j p_ij dp_ij) * (z_ij >= 0 ? 1 : slope)
//   d a_dst[b,i,h] = sum_j dz_ij            (row sums)
//   d a_src[b,j,h] = sum_i dz_ij            (column sums)
//   d v[b,j,h,:]   = sum_i p_ij dO[b,i,h,:]
//
// The sign is that of the pre-activation z, not of LeakyReLU(z); at exactly
// 0 the factor is 1. Masked cells have p = 0 and contribute nothing.
//
// The TPU kernel forms the dense n x n tiles and three MXU products. Here
// the work follows the mask's set cells, given compressed (MaskIndex: by
// row, and the same entries sorted by column). The column sums collide
// between rows, so there are two kernels and no atomics; the sums are taken
// in a fixed order and a run repeats to the bit:
//
//   1. rows:    one warp per (b, i, h). Lanes own the row's entries: max, exp
//               and sum; per entry a warp-wide dot product over C for dp;
//               then dz. Writes p and dz per entry into scratch ([B, H, nnz]
//               each) and d a_dst.
//   2. columns: one warp per (b, j, h) walks the entries of column j:
//               d a_src = sum dz, and with the channels over the lanes
//               d v = sum p dO. Every output element is written once.
//
// The mask need not be symmetric: the column lists are built from it.
//
// Bound: bytes (v, dO read once; d v written once; p and dz cross device
// memory once, 2 B H nnz floats).
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__global__ void __launch_bounds__(kWarps * 32)
rows_kernel(const float* __restrict__ a_dst,     // [B, n, H]
            const float* __restrict__ a_src,     // [B, n, H]
            const float* __restrict__ v,         // [B, n, H, C]
            const float* __restrict__ dout,      // [B, n, H, C]
            const int* __restrict__ row_ptr,     // [n + 1]
            const int* __restrict__ col,         // [nnz]
            float* __restrict__ p_out,           // [B, H, nnz]
            float* __restrict__ dz_out,          // [B, H, nnz]
            float* __restrict__ d_a_dst,         // [B, n, H]
            int B, int n, int H, int C, int nnz, float slope) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * n * H) return;
  const int h = (int)(warp % H);
  const long long i = (warp / H) % n;
  const long long b = warp / H / n;
  const long long HC = (long long)H * C;

  const int k0 = row_ptr[i], k1 = row_ptr[i + 1];
  const float ad = a_dst[(b * n + i) * H + h];
  const float* as = a_src + b * n * H + h;
  const float* vb = v + b * n * HC + (long long)h * C;
  const float* drow = dout + (b * n + i) * HC + (long long)h * C;
  float* pk = p_out + (b * H + h) * (long long)nnz;
  float* dzk = dz_out + (b * H + h) * (long long)nnz;

  // pass 1: max of the LeakyReLU logits over the row's entries
  float m = -INFINITY;
  for (int k = k0 + lane; k < k1; k += 32) {
    float z = ad + as[(long long)col[k] * H];
    z = z >= 0.f ? z : slope * z;
    m = fmaxf(m, z);
  }
  m = warp_max(m);

  // pass 2: e_k = exp(z_k - m), dp_k = dO . v_k; the lane that owns entry k
  // keeps both in the scratch rows (it reads them back itself in pass 3)
  float Z = 0.f, num = 0.f;
  for (int kc = k0; kc < k1; kc += 32) {
    const int k = kc + lane;
    int j = 0;
    float e = 0.f;
    if (k < k1) {
      j = col[k];
      float z = ad + as[(long long)j * H];
      z = z >= 0.f ? z : slope * z;
      e = expf(z - m);
    }
    float dp = 0.f;
    const int cnt = min(32, k1 - kc);
    for (int s = 0; s < cnt; ++s) {
      const int js = __shfl_sync(kFull, j, s);
      const float* vr = vb + (long long)js * HC;
      float part = 0.f;
      for (int c = lane; c < C; c += 32) part = fmaf(drow[c], __ldg(vr + c), part);
      part = warp_sum(part);
      if (lane == s) dp = part;
    }
    if (k < k1) {
      Z += e;
      num = fmaf(e, dp, num);
      pk[k] = e;
      dzk[k] = dp;
    }
  }
  Z = warp_sum(Z);
  const float delta = warp_sum(num) / Z;

  // pass 3: p_k = e_k / Z, dz_k = p_k (dp_k - delta), slope where z_k < 0
  float dsum = 0.f;
  for (int k = k0 + lane; k < k1; k += 32) {
    const float p = pk[k] / Z;
    float dz = p * (dzk[k] - delta);
    if (!(ad + as[(long long)col[k] * H] >= 0.f)) dz *= slope;
    pk[k] = p;
    dzk[k] = dz;
    dsum += dz;
  }
  dsum = warp_sum(dsum);
  if (lane == 0) d_a_dst[(b * n + i) * H + h] = dsum;
}

__global__ void __launch_bounds__(kWarps * 32)
columns_kernel(const float* __restrict__ dout,     // [B, n, H, C]
               const float* __restrict__ p_in,     // [B, H, nnz]
               const float* __restrict__ dz_in,    // [B, H, nnz]
               const int* __restrict__ t_ptr,      // [n + 1]
               const int* __restrict__ t_entry,    // [nnz]
               const int* __restrict__ t_row,      // [nnz]
               float* __restrict__ d_a_src,        // [B, n, H]
               float* __restrict__ d_v,            // [B, n, H, C]
               int B, int n, int H, int C, int nnz) {
  const int lane = threadIdx.x & 31;
  const long long warp = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (warp >= (long long)B * n * H) return;
  const int h = (int)(warp % H);
  const long long j = (warp / H) % n;
  const long long b = warp / H / n;
  const long long HC = (long long)H * C;

  const int t0 = t_ptr[j], t1 = t_ptr[j + 1];
  const float* pk = p_in + (b * H + h) * (long long)nnz;
  const float* dzk = dz_in + (b * H + h) * (long long)nnz;

  // d a_src[b, j, h]: every lane takes the same walk, lane 0 writes
  float dsum = 0.f;
  for (int t = t0; t < t1; ++t) dsum += dzk[t_entry[t]];
  if (lane == 0) d_a_src[(b * n + j) * H + h] = dsum;

  // d v[b, j, h, :] = sum p_k dO[row_k]
  const float* dbase = dout + b * n * HC + (long long)h * C;
  float* vrow = d_v + (b * n + j) * HC + (long long)h * C;
  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
    for (int t = t0; t < t1; ++t) {
      const float p = pk[t_entry[t]];
      const float* dr = dbase + (long long)t_row[t] * HC + c0;
#pragma unroll
      for (int q = 0; q < kPerLane; ++q) {
        const int c = lane + 32 * q;
        if (c0 + c < C) acc[q] = fmaf(p, __ldg(dr + c), acc[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < C) vrow[c0 + c] = acc[q];
    }
  }
}

inline unsigned blocks_for(long long warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

}  // namespace

// scratch_p, scratch_dz: [B, H, nnz] f32. All outputs are written in full.
extern "C" int fused_attention_bwd(
    const float* a_dst, const float* a_src, const float* v, const float* dout,
    const int* row_ptr, const int* col, const int* t_ptr, const int* t_entry,
    const int* t_row, float* scratch_p, float* scratch_dz, float* d_a_dst,
    float* d_a_src, float* d_v, int B, int n, int H, int C, int nnz,
    float slope, void* stream) {
  const long long warps = (long long)B * n * H;
  if (warps == 0) return (int)cudaSuccess;
  cudaStream_t st = (cudaStream_t)stream;
  rows_kernel<<<blocks_for(warps), kWarps * 32, 0, st>>>(
      a_dst, a_src, v, dout, row_ptr, col, scratch_p, scratch_dz, d_a_dst, B,
      n, H, C, nnz, slope);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  columns_kernel<<<blocks_for(warps), kWarps * 32, 0, st>>>(
      dout, scratch_p, scratch_dz, t_ptr, t_entry, t_row, d_a_src, d_v, B, n,
      H, C, nnz);
  return (int)cudaGetLastError();
}
