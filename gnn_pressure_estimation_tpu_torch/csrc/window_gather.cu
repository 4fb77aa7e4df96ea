// Windowed neighbour gather, forward and backward, for Hopper (sm_90a).
//
// Replaces _window_gather_raw in
// gnn_pressure_estimation_tpu/ops/pallas/window_gather.py, and the masked
// slot sum that make_window_gather's backward runs after it (:260-266). A
// table lists, per block of BLK rows and per slot, a window start ws[blk] and
// window-relative ids rel[blk, r*D + d], with rel == W marking an empty slot:
//
//   forward:  out[blk*BLK + r, d, :] = rel == W ? 0 : x[ws[blk] + rel, :]
//   backward: xbar[blk*BLK + r, :]   = sum over d2 with rel != W of
//                                      g[ws[blk] + rel[blk, r*D2 + d2], :]
//
// The backward's source is the cotangent's flattened [n_pad*D, C] slot grid
// and its table the transpose (out-slot) table, so neither direction
// scatters. The sentinel is the table's slot mask: the reference's masked
// sum keeps exactly the slots whose rel is not W.
//
// The TPU kernel copies the window into VMEM and selects slots with a
// one-hot(rel) x window matmul on the MXU, because a TPU has no fast gather,
// and pads C to 128 lanes. A GPU gathers natively: one warp per slot row
// (forward) or per output row (backward) reads the row id and copies or
// sums C floats: 16 bytes a lane when C is a multiple of 4 and both arrays
// start 16-byte aligned (every row then does), one float a lane otherwise.
// Any C. The backward sums its slots in registers and writes the row once:
// the [n_pad, D2, C] intermediate of the reference is never written.
//
// Bound: bytes. The forward writes n_slots*C floats and reads at most as
// many; the backward reads the slot grid once and writes n_pad*C. Offsets
// are 64-bit (the slot grid at bigtown B 32, C 256 holds 2.9e8 floats).
//
// C interface: pointers, ints and the stream; returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;               // warps per thread block

__global__ void __launch_bounds__(kWarps * 32)
gather_kernel(const float* __restrict__ x,          // [n_src, C]
              const int* __restrict__ rel,          // [nB, BLK*D]
              const int* __restrict__ win_start,    // [nB]
              float* __restrict__ out,              // [nB*BLK*D, C]
              long long n_slots, int slots_per_blk, int W, int C, bool vec4) {
  const int lane = threadIdx.x & 31;
  const long long s = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (s >= n_slots) return;
  const int r = rel[s];                  // rel is laid out in slot order
  float* dst = out + s * C;
  if (r == W) {
    for (int c = lane; c < C; c += 32) dst[c] = 0.f;
    return;
  }
  const float* src = x + ((long long)win_start[s / slots_per_blk] + r) * C;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = lane; c < C / 4; c += 32) d4[c] = __ldg(s4 + c);
  } else {
    for (int c = lane; c < C; c += 32) dst[c] = __ldg(src + c);
  }
}

__global__ void __launch_bounds__(kWarps * 32)
gather_sum_kernel(const float* __restrict__ g,        // [n_src, C]
                  const int* __restrict__ rel,        // [nB, BLK*D2]
                  const int* __restrict__ win_start,  // [nB]
                  float* __restrict__ out,            // [nB*BLK, C]
                  long long n_rows, int BLK, int D2, int W, int C, bool vec4) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const int* rrow = rel + row * D2;      // [blk, (row % BLK) * D2 ...] == row * D2
  const long long ws = win_start[row / BLK];
  float* dst = out + row * C;
  if (vec4) {
    const int C4 = C / 4;
    for (int c0 = 0; c0 < C4; c0 += 32) {
      const int c = c0 + lane;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int d = 0; d < D2; ++d) {
        const int r = rrow[d];
        if (r == W || c >= C4) continue;
        const float4 v = __ldg(reinterpret_cast<const float4*>(g + (ws + r) * C) + c);
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      if (c < C4) reinterpret_cast<float4*>(dst)[c] = acc;
    }
  } else {
    for (int c0 = 0; c0 < C; c0 += 32) {
      const int c = c0 + lane;
      float acc = 0.f;
      for (int d = 0; d < D2; ++d) {
        const int r = rrow[d];
        if (r == W || c >= C) continue;
        acc += __ldg(g + (ws + r) * C + c);
      }
      if (c < C) dst[c] = acc;
    }
  }
}

inline unsigned blocks_for(long long warps) {
  return (unsigned)((warps + kWarps - 1) / kWarps);
}

inline bool vec4_ok(const void* a, const void* b, int C) {
  return (C & 3) == 0 && ((uintptr_t)a & 15) == 0 && ((uintptr_t)b & 15) == 0;
}

}  // namespace

extern "C" int window_gather_fwd(const float* x, const int* rel,
                                 const int* win_start, float* out, int nB,
                                 int BLK, int D, int W, int C, void* stream) {
  const long long n_slots = (long long)nB * BLK * D;
  if (n_slots == 0 || C == 0) return (int)cudaSuccess;
  gather_kernel<<<blocks_for(n_slots), kWarps * 32, 0, (cudaStream_t)stream>>>(
      x, rel, win_start, out, n_slots, BLK * D, W, C, vec4_ok(x, out, C));
  return (int)cudaGetLastError();
}

extern "C" int window_gather_bwd(const float* g, const int* rel,
                                 const int* win_start, float* out, int nB,
                                 int BLK, int D2, int W, int C, void* stream) {
  const long long n_rows = (long long)nB * BLK;
  if (n_rows == 0 || C == 0) return (int)cudaSuccess;
  gather_sum_kernel<<<blocks_for(n_rows), kWarps * 32, 0, (cudaStream_t)stream>>>(
      g, rel, win_start, out, n_rows, BLK, D2, W, C, vec4_ok(g, out, C));
  return (int)cudaGetLastError();
}
