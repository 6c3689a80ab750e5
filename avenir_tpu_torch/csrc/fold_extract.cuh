// The k-round extraction shared by the fold kernels (fold.cu: K6, K8-K10,
// f32 metrics; fold_int8.cu: K11, K12, int32 metrics), in two forms.
//
// extract_rows, for the CUDA-core bodies: after a block's sweep its kR x kB
// (value, column) pairs sit in shared memory. One warp per row runs k
// rounds: a strided scan for the lane's smallest (value, column) pair in
// (value, column) order, a butterfly of shuffles for the warp's, and lane 0
// writes the slot and masks the pair taken to `big`. Slots past k hold
// (big, -1). Pairs are unique but for the empty (big, -1) buckets, so
// masking the value at the winner's position masks exactly the pair taken.
//
// tc_extract_kernel, for the tensor-core bodies, whose bucket slices merge
// through an [m][kB] (value, column) scratch in global memory: the same k
// rounds, a warp a row, over the row's pairs in shared memory (below).

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

// 16 bytes of values
template <typename T>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

// the warp's smallest (value, column) pair, and the tag its holder gave it
template <typename T>
__device__ __forceinline__ void warp_min_pair(T& v, int& x, int& tag) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const T ov = __shfl_xor_sync(0xffffffffu, v, off);
    const int ox = __shfl_xor_sync(0xffffffffu, x, off);
    const int ot = __shfl_xor_sync(0xffffffffu, tag, off);
    if (ov < v || (ov == v && ox < x)) {
      v = ov;
      x = ox;
      tag = ot;
    }
  }
}

// rows a block of tc_extract_kernel: as many as fit 48 KB of shared
// memory, at most 8
template <typename T, int kB>
__host__ __device__ constexpr int tc_extract_rows() {
  return 48 * 1024 / (32 * (kB / 32 + 1) * (sizeof(T) + sizeof(int))) < 8
             ? 48 * 1024 / (32 * (kB / 32 + 1) * (sizeof(T) + sizeof(int)))
             : 8;
}

// The k rounds over vals / cols [m][kB], a warp a row. The row's pairs are
// copied to shared memory with 16-byte loads: lane l owns buckets 4 (l +
// 32 q) + e, kept in a segment of kB / 32 + 1 entries (the pad puts the
// lanes' entries on distinct banks), and takes its segment's smallest
// (value, column) pair into registers. A round takes the warp's smallest
// of the lanes' pairs by a butterfly and lane 0 writes the slot; the owner
// marks the pair taken (its value above every value), and the whole warp
// rescans the owner's segment, kB / 1024 entries a lane (at most one below
// 1,024 buckets), for the owner's next smallest pair. A round costs two
// butterflies whatever kB is. Slots past k hold (big, -1). At 8,192 rows
// on an NVIDIA H100 80GB HBM3 at 700 W (us), against each lane scanning
// its kB / 32 register pairs every round: K12 at 2,048 buckets, k = 16,
// 86 against 460; at 512, k = 16, 29 against 51; K6 (k = 5) at 1,024,
// 512 and 128 buckets 37, 18 and 11 against 36, 16 and 8. Taking the
// lanes' minima straight from the loads, K6 at 1,024 and K12 at 2,048
// buckets ran 35 and 118 (16-byte loads) or 49 and 81 (4-byte loads).
template <typename T, int kB>
__global__ void __launch_bounds__(32 * tc_extract_rows<T, kB>())
tc_extract_kernel(const T* __restrict__ vals, const int* __restrict__ cols,
                  int m, int k, T big, T* __restrict__ out_d,
                  int* __restrict__ out_i) {
  constexpr int kPer = kB / 32;
  constexpr int kStride = kPer + 1;
  constexpr int kRows = tc_extract_rows<T, kB>();
  __shared__ T sv[kRows][32 * kStride];
  __shared__ int sx[kRows][32 * kStride];
  const int lane = threadIdx.x & 31;
  const int r = threadIdx.x >> 5;
  const int row = blockIdx.x * kRows + r;
  if (row >= m) return;
  T* seg_v = sv[r];
  int* seg_x = sx[r];
  using V4 = typename Vec4<T>::type;
  const V4* vr =
      reinterpret_cast<const V4*>(vals + static_cast<size_t>(row) * kB);
  const int4* cr =
      reinterpret_cast<const int4*>(cols + static_cast<size_t>(row) * kB);
#pragma unroll
  for (int q = 0; q < kPer / 4; ++q) {
    const V4 f = vr[lane + 32 * q];
    const int4 n = cr[lane + 32 * q];
    T* dv = seg_v + lane * kStride + 4 * q;
    int* dx = seg_x + lane * kStride + 4 * q;
    dv[0] = f.x, dv[1] = f.y, dv[2] = f.z, dv[3] = f.w;
    dx[0] = n.x, dx[1] = n.y, dx[2] = n.z, dx[3] = n.w;
  }
  T lv = above_all<T>();
  int lx = INT_MAX;
  int lu = 0;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const T v = seg_v[lane * kStride + u];
    const int x = seg_x[lane * kStride + u];
    if (v < lv || (v == lv && x < lx)) {
      lv = v;
      lx = x;
      lu = u;
    }
  }
  const size_t out = static_cast<size_t>(row) * kLanes;
  for (int slot = 0; slot < k; ++slot) {
    T bv = lv;
    int bx = lx;
    int owner = lane;
    warp_min_pair(bv, bx, owner);
    // the empty (big, -1) pairs tie: lane 0's view names the one taken
    owner = __shfl_sync(0xffffffffu, owner, 0);
    if (lane == 0) {
      out_d[out + slot] = bv;
      out_i[out + slot] = bx;
    }
    __syncwarp();   // the previous round's rescan has read the segment
    if (lane == owner) seg_v[lane * kStride + lu] = above_all<T>();
    __syncwarp();
    const T* ov = seg_v + owner * kStride;
    const int* ox = seg_x + owner * kStride;
    T cv = above_all<T>();
    int cx = INT_MAX;
    int cu = 0;
#pragma unroll
    for (int q = 0; q < (kPer + 31) / 32; ++q) {
      const int u = lane + 32 * q;
      if (u < kPer && (ov[u] < cv || (ov[u] == cv && ox[u] < cx))) {
        cv = ov[u];
        cx = ox[u];
        cu = u;
      }
    }
    warp_min_pair(cv, cx, cu);
    if (lane == owner) {
      lv = cv;
      lx = cx;
      lu = cu;
    }
  }
  for (int slot = k + lane; slot < kLanes; slot += 32) {
    out_d[out + slot] = big;
    out_i[out + slot] = -1;
  }
}

// launch tc_extract_kernel over m rows
template <typename T, int kB>
cudaError_t tc_extract(const T* vals, const int* cols, int m, int k, T big,
                       T* out_d, int* out_i, cudaStream_t s) {
  constexpr int kRows = tc_extract_rows<T, kB>();
  tc_extract_kernel<T, kB><<<(m + kRows - 1) / kRows, 32 * kRows, 0, s>>>(
      vals, cols, m, k, big, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace avt
