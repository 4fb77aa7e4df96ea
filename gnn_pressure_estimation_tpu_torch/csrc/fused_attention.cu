// Fused dense-mode GAT attention, forward, for Hopper (sm_90a).
//
// Replaces the forward of make_fused_attention in
// gnn_pressure_estimation_tpu/ops/pallas/graph_attention.py (fwd_kernel).
// With M the template's [n, n] adjacency mask (self-loops in) and
// z_ij = a_dst[b,i,h] + a_src[b,j,h] (one f32 add):
//
//   out[b,i,h,:] = sum_j softmax_j(M_ij ? (z_ij >= 0 ? z_ij : slope z_ij)
//                                       : -1e9) v[b,j,h,:]
//
// Layout: a_dst, a_src [B, n, H]; v, out [B, n, H, C] (the layer's own; the
// TPU kernel takes [B, H, n, C] and pads n to 128 lanes).
//
// The TPU kernel forms the whole n x n softmax per (graph, head) and
// multiplies it with V on the MXU. The mask of a water network is about 1%
// dense and every row holds its diagonal, so a masked cell's weight is
// exp(-1e9 - max) = 0 exactly and the sum runs over the row's set cells only,
// given as a row list (MaskIndex: row_ptr, col). One warp per (b, i, h):
// lanes own the row's entries for the max and the sum of exponentials, then
// the entries are broadcast by shuffle and the channels spread over the lanes.
//
// Bound: bytes (v read once, out written once; the a's and the index are
// small). Per nonzero the kernel does 2 C flops.
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
fused_attention_fwd_kernel(const float* __restrict__ a_dst,   // [B, n, H]
                           const float* __restrict__ a_src,   // [B, n, H]
                           const float* __restrict__ v,       // [B, n, H, C]
                           const int* __restrict__ row_ptr,   // [n + 1]
                           const int* __restrict__ col,       // [nnz]
                           float* __restrict__ out,           // [B, n, H, C]
                           int B, int n, int H, int C, float slope) {
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
  float* orow = out + (b * n + i) * HC + (long long)h * C;

  // pass 1: max of the LeakyReLU logits over the row's entries
  float m = -INFINITY;
  for (int k = k0 + lane; k < k1; k += 32) {
    float z = ad + as[(long long)col[k] * H];
    z = z >= 0.f ? z : slope * z;
    m = fmaxf(m, z);
  }
  m = warp_max(m);

  // pass 2: the softmax denominator
  float Z = 0.f;
  for (int k = k0 + lane; k < k1; k += 32) {
    float z = ad + as[(long long)col[k] * H];
    z = z >= 0.f ? z : slope * z;
    Z += expf(z - m);
  }
  Z = warp_sum(Z);

  // pass 3: out = sum_k p_k v[col_k]; 32 entries at a time, one per lane,
  // broadcast in turn while the lanes hold the channels
  for (int c0 = 0; c0 < C; c0 += kTile) {
    float acc[kPerLane];
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) acc[q] = 0.f;
    for (int kc = k0; kc < k1; kc += 32) {
      const int k = kc + lane;
      int j = 0;
      float p = 0.f;
      if (k < k1) {
        j = col[k];
        float z = ad + as[(long long)j * H];
        z = z >= 0.f ? z : slope * z;
        p = expf(z - m) / Z;
      }
      const int cnt = min(32, k1 - kc);
      for (int s = 0; s < cnt; ++s) {
        const int js = __shfl_sync(kFull, j, s);
        const float ps = __shfl_sync(kFull, p, s);
        const float* vr = vb + (long long)js * HC + c0;
#pragma unroll
        for (int q = 0; q < kPerLane; ++q) {
          const int c = lane + 32 * q;
          if (c0 + c < C) acc[q] = fmaf(ps, __ldg(vr + c), acc[q]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPerLane; ++q) {
      const int c = lane + 32 * q;
      if (c0 + c < C) orow[c0 + c] = acc[q];
    }
  }
}

}  // namespace

extern "C" int fused_attention_fwd(const float* a_dst, const float* a_src,
                                   const float* v, const int* row_ptr,
                                   const int* col, float* out, int B, int n,
                                   int H, int C, float slope, void* stream) {
  const long long warps = (long long)B * n * H;
  if (warps == 0 || C == 0) return (int)cudaSuccess;
  const long long blocks = (warps + kWarps - 1) / kWarps;
  fused_attention_fwd_kernel<<<(unsigned)blocks, kWarps * 32, 0,
                               (cudaStream_t)stream>>>(
      a_dst, a_src, v, row_ptr, col, out, B, n, H, C, slope);
  return (int)cudaGetLastError();
}
