// K6-K10: the lane-bucket fold of the KNN experiment kernels on Hopper
// (sm_90a).
//
// K6 replaces `_acc_kernel` (scripts/exp_fold.py:24, launched from
// `acc_topk` at :91). K7 replaces `_dotmin_kernel`, K8 `_nodot_kernel` and
// K9 `_tpose_kernel` (scripts/roofline_knn.py:75, :98, :142, launched at
// :205, :255 and :225). K10 replaces the f32 uses of `_tag_kernel` without
// an epilogue (scripts/sweep16_kernels.py:71 `augbf16`,
// scripts/sweep16b_kernels.py:77 `augv2`) and `_tpose_aug_kernel`
// (scripts/sweep18_tpose_fold.py:110). All five are one template here, with
// compile-time flags for the layout (row-major or feature-major operands),
// the metric (a product or a broadcast; with or without the y2 epilogue)
// and the output (indexed or values only). The TPU's scalar-tag index fold
// is no different function here: a thread owns a bucket and walks its
// columns in order, so the column is t0 + tid whether the TPU kept an iota
// or a tag.
//
// What they compute, for each test row r and train column col < n:
//   K6, K9  metric = y2[col] - 2 * <x_r, y_col>, x and y rounded to bf16
//           (round to nearest even) before the product, summed in f32; K6
//           takes the f32 operands as they are when its round flag is off.
//           K9's operands arrive feature-major: xt [d][m], yt [d][n].
//   K7      the same metric (rounded), folded into 128 lanes by a plain
//           minimum, no index: out_d[r][l] = min over col % 128 == l.
//   K8      metric = y2[col] + sum_d x[r][d] (f32, summed in feature order),
//           no product; y is not read.
//   K10     metric = sum_c bf16(x[r][c]) * bf16(y[col][c]), the raw product
//           of operands the caller augmented ([x | 1 | 1] against
//           [-2y | y2hi | y2lo]): no y2 operand, no epilogue. The products
//           of bf16 values are exact in f32; they are summed by FMAs in
//           feature order, c = 0, 1, ..., which the plain version repeats
//           (the y2 columns are some 2^8 times the others, so the order
//           shows in the last bits). Row-major or feature-major.
// Indexed kernels fold into B = n_acc * 128 buckets, col falling in bucket
// col % B: each bucket keeps the smallest metric strictly below BIG and the
// lowest column reaching it, else (BIG, -1). Then k rounds extract, per
// row, the smallest (value, column) pair in (value, column) order, masking
// the pair taken, into out [m][128]; slots past k hold (BIG, -1).
//
// What bounds them on an H100: the per-pair instructions on the CUDA cores.
// A product of bf16-rounded operands summed in f32 is what the tensor cores
// do at 989 TFLOP/s (2 * m * n * d flops: 0.010 ms at the bench shape), so
// the floor of K6, K7 and K9 is the fold that consumes each pair: the
// metric, a compare and two selects (K7: the metric and a min), at 128
// lanes per SM and clock. K8 has no product and the same fold. These
// kernels do the product on the CUDA cores too, d FMAs a pair beside the
// fold's 4, so they can reach at most 4 / (d + 4) of that floor (K7:
// 2 / (d + 2)). K10's fold spends 3 (no epilogue) beside d + 2 FMAs. Memory is
// not the limit: the train set is read once per block from L2 (2.4 MB at
// the bench shape, in the 50 MB L2).
//
// Design: where the TPU grid carries its accumulators across train tiles in
// VMEM, a Hopper block owns kR whole test rows and sweeps all of n itself.
// - A block has B threads, one per bucket, and kR test rows: 16, or 8 at
//   B = 1024 where a thread may hold only 64 registers. K7 runs K6's block
//   of 512 (four buckets a lane, one minimum each, no column) and takes
//   each lane's minimum of its four at the end: a first K7 of 128 threads,
//   one a lane, ran slower than K6 at the bench shape (0.84 against 0.80
//   ms, 512 blocks of four warps), which would have made the decomposition
//   read the block shape instead of the work. The rows' features sit in shared memory, d-major, so a thread
//   reads four rows of one feature with one 16-byte broadcast load.
// - Thread b visits columns b, b + B, b + 2B, ... in increasing order; a
//   strict < gives the lowest column on ties for free. It keeps its kR
//   (value, column) pairs in registers.
// - Row-major operands (K6, K7): each step stages B train rows of y, a
//   contiguous run of B * d floats, into shared memory with coalesced loads
//   (rounded as they land); a thread then reads its row at stride d, free of
//   bank conflicts for odd d. Feature-major operands (K9): thread b reads
//   yt[c][col] straight from global memory, coalesced across the warp, with
//   no staging and no barrier.
// - After the sweep the kR x B pairs go to shared memory (at most 64 KB);
//   one warp per row runs the k rounds (fold_extract.cuh).
//
// Interface: plain C, bound from Python with ctypes; the caller allocates
// out_d (and out_i) [m][128]. Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

#include "fold_extract.cuh"

namespace {

using avt::kLanes;

constexpr float kBig = 3.0e38f;
constexpr int kMaxD = 48;
// K7's block: four buckets a lane, K6's shape at n_acc = 4, so that K7
// differs from K6 only in what it keeps of the sweep
constexpr int kDotminThreads = 512;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int kB>
__host__ __device__ constexpr int rows_per_block() {
  return kB >= 1024 ? 8 : 16;
}

// A block of 512 threads must leave room for a second one on its SM (64
// registers a thread): with one, K6 ran 1.08 ms at the bench shape, with
// two 0.80.
template <int kB>
__host__ __device__ constexpr int blocks_per_sm() {
  return kB == 512 ? 2 : 1;
}

// kTpose: x is xt [d][m] and y is yt [d][n]; kDot: the product metric (K8's
// broadcast otherwise); kEpi: the y2 epilogue (K10's raw product otherwise,
// y2 is not read); kIndexed: bucket fold and extraction (K7's lane minima
// otherwise).
template <bool kTpose, bool kDot, bool kEpi, bool kIndexed, int kB>
__global__ void __launch_bounds__(kB, blocks_per_sm<kB>())
fold_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ y2, int m, int n, int d, int k,
            int round_bf16, float* __restrict__ out_d,
            int* __restrict__ out_i) {
  constexpr int kR = rows_per_block<kB>();
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                                 // [d][kR]
  float* ys = xs + static_cast<size_t>(d) * kR;     // [kB][d], row-major dot
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kR;

  for (int e = tid; e < d * kR; e += kB) {
    const int c = e / kR;
    const int r = e - c * kR;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < m) {
      v = kTpose ? x[static_cast<size_t>(c) * m + gr]
                 : x[static_cast<size_t>(gr) * d + c];
      if (kDot && round_bf16) v = bf16_round(v);
    }
    xs[e] = v;
  }
  __syncthreads();

  float s[kR];  // K8: each row's feature sum, in feature order
  if constexpr (!kDot) {
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      s[r] = 0.f;
      for (int c = 0; c < d; ++c) s[r] += xs[c * kR + r];
    }
  }

  float bd[kR];
  int bi[kR];
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    bd[r] = kBig;
    bi[r] = -1;
  }

  const size_t y_len = static_cast<size_t>(n) * d;
  for (int t0 = 0; t0 < n; t0 += kB) {
    if constexpr (kDot && !kTpose) {
      __syncthreads();  // the previous tile is fully read
      const size_t base = static_cast<size_t>(t0) * d;
      for (int e = tid; e < kB * d; e += kB) {
        const size_t g = base + e;
        float v = g < y_len ? y[g] : 0.f;
        if (round_bf16) v = bf16_round(v);
        ys[e] = v;
      }
      __syncthreads();
    }
    const int col = t0 + tid;
    if (col >= n) continue;  // a column past n never wins
    float v[kR];
    float y2v = 0.f;
    if constexpr (kEpi) y2v = y2[col];
    if constexpr (kDot) {
      float acc[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) acc[r] = 0.f;
      for (int c = 0; c < d; ++c) {
        float yv;
        if constexpr (kTpose) {
          yv = y[static_cast<size_t>(c) * n + col];
          if (round_bf16) yv = bf16_round(yv);
        } else {
          yv = ys[tid * d + c];
        }
        const float4* xq = reinterpret_cast<const float4*>(xs + c * kR);
#pragma unroll
        for (int q = 0; q < kR / 4; ++q) {
          const float4 xv = xq[q];
          acc[4 * q] = fmaf(xv.x, yv, acc[4 * q]);
          acc[4 * q + 1] = fmaf(xv.y, yv, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xv.z, yv, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xv.w, yv, acc[4 * q + 3]);
        }
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) v[r] = kEpi ? y2v - 2.f * acc[r] : acc[r];
    } else {
#pragma unroll
      for (int r = 0; r < kR; ++r) v[r] = y2v + s[r];
    }
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (v[r] < bd[r]) {
        bd[r] = v[r];
        bi[r] = col;
      }
    }
  }

  __syncthreads();  // xs and ys are no longer read
  if constexpr (!kIndexed) {
    // K7: lane l's minimum over its kB / 128 buckets l, l + 128, ...
    float* pm = smem;  // [kR][kB]
#pragma unroll
    for (int r = 0; r < kR; ++r) pm[r * kB + tid] = bd[r];
    __syncthreads();
    if (tid < kLanes) {
      for (int r = 0; r < kR; ++r) {
        const int gr = row0 + r;
        if (gr >= m) break;
        float v = pm[r * kB + tid];
        for (int b = kLanes; b < kB; b += kLanes) {
          const float w = pm[r * kB + tid + b];
          v = w < v ? w : v;
        }
        out_d[static_cast<size_t>(gr) * kLanes + tid] = v;
      }
    }
    return;
  }

  float* pd = smem;                                             // [kR][kB]
  int* pi = reinterpret_cast<int*>(smem + kR * kB);             // [kR][kB]
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    pd[r * kB + tid] = bd[r];
    pi[r * kB + tid] = bi[r];
  }
  __syncthreads();

  avt::extract_rows<float, kB, kB>(pd, pi, kR, row0, m, k, kBig, out_d,
                                   out_i);
}

template <bool kTpose, bool kDot, bool kEpi, bool kIndexed, int kB>
cudaError_t launch(const float* x, const float* y, const float* y2, int m,
                   int n, int d, int k, int round_bf16, float* out_d,
                   int* out_i, cudaStream_t stream) {
  constexpr int kR = rows_per_block<kB>();
  size_t sweep = static_cast<size_t>(d) * kR;
  if (kDot && !kTpose) sweep += static_cast<size_t>(kB) * d;
  const size_t extract = static_cast<size_t>(kR) * kB * (kIndexed ? 2 : 1);
  const size_t smem = (sweep > extract ? sweep : extract) * sizeof(float);
  auto kernel = fold_kernel<kTpose, kDot, kEpi, kIndexed, kB>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(m + kR - 1) / kR, kB, smem, stream>>>(x, y, y2, m, n, d, k,
                                                   round_bf16, out_d, out_i);
  return cudaGetLastError();
}

template <bool kTpose, bool kDot, bool kEpi>
cudaError_t launch_indexed(const void* x, const void* y, const void* y2,
                           int m, int n, int d, int k, int n_acc,
                           int round_bf16, void* out_d, void* out_i,
                           int device, void* stream) {
  if (m <= 0 || n <= 0 || d <= 0 || d > kMaxD || k < 1 || k > kLanes) {
    return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const float* xf = static_cast<const float*>(x);
  const float* yf = static_cast<const float*>(y);
  const float* y2f = static_cast<const float*>(y2);
  float* od = static_cast<float*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AVT_FOLD(B)                                                          \
  launch<kTpose, kDot, kEpi, true, B>(xf, yf, y2f, m, n, d, k, round_bf16, \
                                      od, oi, s)
  switch (n_acc) {
    case 1: return AVT_FOLD(128);
    case 2: return AVT_FOLD(256);
    case 4: return AVT_FOLD(512);
    case 8: return AVT_FOLD(1024);
    default: return cudaErrorInvalidValue;
  }
#undef AVT_FOLD
}

}  // namespace

extern "C" {

// K6: x [m, d], y [n, d] row-major; round_bf16 rounds both before the dot.
int avt_fold_acc(const void* x, const void* y, const void* y2, int m, int n,
                 int d, int k, int n_acc, int round_bf16, void* out_d,
                 void* out_i, int device, void* stream) {
  return static_cast<int>(launch_indexed<false, true, true>(
      x, y, y2, m, n, d, k, n_acc, round_bf16, out_d, out_i, device, stream));
}

// K7: x [m, d], y [n, d] row-major, rounded; out_d [m, 128] lane minima.
int avt_fold_dotmin(const void* x, const void* y, const void* y2, int m,
                    int n, int d, void* out_d, int device, void* stream) {
  if (m <= 0 || n <= 0 || d <= 0 || d > kMaxD) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<false, true, true, false, kDotminThreads>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(y2), m, n, d, 0, 1,
      static_cast<float*>(out_d), nullptr, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// K8: x [m, d]; y2 [n]; the metric y2[col] + sum_d x[r][d].
int avt_fold_nodot(const void* x, const void* y2, int m, int n, int d, int k,
                   int n_acc, void* out_d, void* out_i, int device,
                   void* stream) {
  return static_cast<int>(launch_indexed<false, false, true>(
      x, nullptr, y2, m, n, d, k, n_acc, 0, out_d, out_i, device, stream));
}

// K9: xt [d, m], yt [d, n] feature-major, rounded to bf16 before the dot.
int avt_fold_tpose(const void* xt, const void* yt, const void* y2, int m,
                   int n, int d, int k, int n_acc, void* out_d, void* out_i,
                   int device, void* stream) {
  return static_cast<int>(launch_indexed<true, true, true>(
      xt, yt, y2, m, n, d, k, n_acc, 1, out_d, out_i, device, stream));
}

// K10: the raw product of augmented operands, rounded to bf16: x [m, d] and
// y [n, d] row-major, or with tpose xt [d, m] and yt [d, n]; no y2.
int avt_fold_raw(const void* x, const void* y, int m, int n, int d, int k,
                 int n_acc, int tpose, void* out_d, void* out_i, int device,
                 void* stream) {
  return static_cast<int>(
      tpose ? launch_indexed<true, true, false>(x, y, nullptr, m, n, d, k,
                                                n_acc, 1, out_d, out_i,
                                                device, stream)
            : launch_indexed<false, true, false>(x, y, nullptr, m, n, d, k,
                                                 n_acc, 1, out_d, out_i,
                                                 device, stream));
}

}  // extern "C"
