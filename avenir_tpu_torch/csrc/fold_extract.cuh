// The k-round extraction shared by the fold kernels (fold.cu: K6, K8-K10,
// f32 metrics; fold_int8.cu: K11, K12, int32 metrics).
//
// After a block's sweep its kR x kB (value, column) pairs sit in shared
// memory. One warp per row runs k rounds: a strided scan for the lane's
// smallest (value, column) pair in (value, column) order, a butterfly of
// shuffles for the warp's, and lane 0 writes the slot and masks the pair
// taken to `big`. Slots past k hold (big, -1). Pairs are unique but for the
// empty (big, -1) buckets, so masking the value at the winner's position
// masks exactly the pair taken.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>

namespace avt {

constexpr int kLanes = 128;

// a value no bucket holds: above BIG and above INT_BIG
template <typename T>
__device__ __forceinline__ T above_all();
template <>
__device__ __forceinline__ float above_all<float>() {
  return CUDART_INF_F;
}
template <>
__device__ __forceinline__ int above_all<int>() {
  return INT_MAX;
}

// pd, pi: [kR][kB] in shared memory, written by the whole block before a
// __syncthreads(); out_d, out_i: [m][128] in global memory.
template <typename T, int kB, int kThreads>
__device__ __forceinline__ void extract_rows(T* pd, int* pi, int k_rows,
                                             int row0, int m, int k, T big,
                                             T* __restrict__ out_d,
                                             int* __restrict__ out_i) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < k_rows; r += kThreads / 32) {
    const int gr = row0 + r;
    if (gr >= m) continue;  // the same for the whole warp
    T* vd = pd + r * kB;
    const int* vi = pi + r * kB;
    const size_t out = static_cast<size_t>(gr) * kLanes;
    for (int slot = 0; slot < k; ++slot) {
      T bv = above_all<T>();
      int bx = INT_MAX;
      int bp = 0;
      for (int j = lane; j < kB; j += 32) {
        const T cv = vd[j];
        const int cx = vi[j];
        if (cv < bv || (cv == bv && cx < bx)) {
          bv = cv;
          bx = cx;
          bp = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int ox = __shfl_xor_sync(0xffffffffu, bx, off);
        const int op = __shfl_xor_sync(0xffffffffu, bp, off);
        if (ov < bv || (ov == bv && ox < bx)) {
          bv = ov;
          bx = ox;
          bp = op;
        }
      }
      if (lane == 0) {
        out_d[out + slot] = bv;
        out_i[out + slot] = bx;
        vd[bp] = big;
      }
      __syncwarp();
    }
    for (int slot = k + lane; slot < kLanes; slot += 32) {
      out_d[out + slot] = big;
      out_i[out + slot] = -1;
    }
  }
}

}  // namespace avt
