// K1 (Naive Bayes joint counts) and K4 (pair contingency counts) on Hopper
// (sm_90a). K4's note is above its kernel, further down.
//
// K1 replaces the TPU kernel `_cfb_kernel` (avenir_tpu/ops/pallas_histogram.py:57,
// launched from `class_feature_bin_counts` at :114). It computes, over rows n,
// the joint count of (feature f, class label, bin) for every valid
// (label, bin) pair:
//
//     out[f][label * B + bin] += weight(n)      (1 when unweighted)
//
// Rows whose label lies outside [0, C) and cells whose bin lies outside
// [0, B) drop out, exactly as the compare-against-iota one-hot of the TPU
// kernel drops them (pallas_histogram.py:71-73).
//
// What bounds it on an H100: the input is read once, N * (F + 1) * 4 bytes
// (plus N * 4 for weights) at 3.35 TB/s, and the output is a few KB. The
// arithmetic is one compare and one add per cell. In practice contention
// on the atomics bounds it: every thread of a block adds into the same
// F * C * B cells, and the churn schema has only 50 of them.
//
// Design:
// - The TPU revisited one VMEM accumulator across a sequential grid. Blocks
//   on Hopper run in parallel and in no order, so each block keeps a private
//   histogram of the [F, C*B] combined ids in shared memory (shared-memory
//   atomics are cheap next to global ones), walks rows with a grid-stride
//   loop, and flushes once into the global array with one global atomicAdd
//   per nonzero cell.
// - Where F * C * B cells do not fit the 227 KB a block may hold, a second
//   variant adds straight into the global array with global atomics.
// - Unweighted counts accumulate in int32: integer adds are exact in any
//   order, so the result is bit-identical run to run whatever the order of
//   the atomics. The wrapper casts once to f32.
// - Weighted counts accumulate f32 with float atomics; 0/1 masks stay exact,
//   other weights carry the usual f32 summation-order caveat
//   (pallas_histogram.py:17-19).
//
// Interface: plain C, bound from Python with ctypes. The caller allocates
// `out` ([F, C*B], int32 unweighted or f32 weighted); this function zeroes it
// on `stream`, launches, and returns the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;
constexpr size_t kMaxSharedBytes = 232448;  // 227 KB: the most a block may use
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <typename Acc, bool kWeighted, bool kShared>
__global__ void __launch_bounds__(kThreads)
cfb_counts_kernel(const int* __restrict__ bins, const int* __restrict__ labels,
                  const float* __restrict__ weights, int n, int f, int c,
                  int b, Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Acc* hist = kShared ? reinterpret_cast<Acc*>(smem_raw) : out;
  const int cb = c * b;
  const int cells = f * cb;
  if (kShared) {
    for (int i = threadIdx.x; i < cells; i += blockDim.x) hist[i] = Acc(0);
    __syncthreads();
  }
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < static_cast<size_t>(n); row += stride) {
    const int label = labels[row];
    if (label < 0 || label >= c) continue;
    const Acc inc = kWeighted ? static_cast<Acc>(weights[row]) : Acc(1);
    const int* r = bins + row * f;
    const int base = label * b;
    for (int j = 0; j < f; ++j) {
      const int bin = r[j];
      if (bin >= 0 && bin < b) atomicAdd(&hist[j * cb + base + bin], inc);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      const Acc v = hist[i];
      if (v != Acc(0)) atomicAdd(&out[i], v);
    }
  }
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || sms <= 0) {
    sms = 132;
  }
  return sms;
}

template <typename Acc, bool kWeighted>
cudaError_t launch(const int* bins, const int* labels, const float* weights,
                   int n, int f, int c, int b, Acc* out, int device,
                   cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(f) * c * b;
  cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(Acc), stream);
  if (err != cudaSuccess) return err;
  const long long want = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  const size_t smem = cells * sizeof(Acc);
  if (smem <= kMaxSharedBytes) {
    auto kernel = cfb_counts_kernel<Acc, kWeighted, true>;
    if (smem > kDefaultSharedBytes) {
      err = cudaFuncSetAttribute(kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<blocks, kThreads, smem, stream>>>(bins, labels, weights, n, f, c,
                                               b, out);
  } else {
    cfb_counts_kernel<Acc, kWeighted, false>
        <<<blocks, kThreads, 0, stream>>>(bins, labels, weights, n, f, c, b,
                                          out);
  }
  return cudaGetLastError();
}

// K4: pair contingency counts.
//
// Replaces the TPU kernel `_pair_kernel` (avenir_tpu/ops/pallas_histogram.py
// :133, launched from `pair_counts` at :178). Over rows n:
//
//     out[a(n)][b(n)] += weight(n)      (1 when unweighted)
//
// Rows whose a id lies outside [0, n_a) or whose b id lies outside [0, n_b)
// drop out, as the compare-against-iota one-hots of the TPU kernel drop them.
//
// What bounds it on an H100: bytes. It reads 2 * N * 4 bytes (plus N * 4 for
// weights) at 3.35 TB/s and writes n_a * n_b cells; one compare and one add
// per row.
//
// Design:
// - The TPU contracted two one-hots on its matrix unit; on Hopper that
//   would be a product of mostly zeros. Each block walks rows in a
//   grid-stride loop and adds into a private shared-memory histogram of the
//   n_a * n_b cells, then flushes one global atomic per nonzero cell.
// - The cells are few on the callers' paths (6 for churn x status, 162 at
//   the widest hospital MI pair), so the 256 threads of a block would
//   hammer a handful of shared addresses. Each warp gets its own copy of the
//   histogram (8 copies x 162 cells x 4 B = 5 KB), or as many copies as fit
//   in 227 KB; the flush sums the copies.
// - Where not even one copy fits in 227 KB, a variant adds straight into
//   the global array with global atomics.
// - Unweighted counts accumulate in int32, exact in any atomic order; the
//   wrapper casts once to f32. Weighted counts accumulate f32.
template <typename Acc, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
pair_counts_kernel(const int* __restrict__ a, const int* __restrict__ b,
                   const float* __restrict__ weights, int n, int n_a, int n_b,
                   int copies, Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int cells = n_a * n_b;
  Acc* hist = copies > 0 ? reinterpret_cast<Acc*>(smem_raw) : out;
  if (copies > 0) {
    for (int i = threadIdx.x; i < copies * cells; i += blockDim.x) {
      hist[i] = Acc(0);
    }
    __syncthreads();
    hist += ((threadIdx.x / 32) % copies) * cells;
  }
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (size_t row = static_cast<size_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       row < static_cast<size_t>(n); row += stride) {
    const int ia = a[row];
    const int ib = b[row];
    if (ia < 0 || ia >= n_a || ib < 0 || ib >= n_b) continue;
    atomicAdd(&hist[ia * n_b + ib],
              kWeighted ? static_cast<Acc>(weights[row]) : Acc(1));
  }
  if (copies > 0) {
    __syncthreads();
    const Acc* base = reinterpret_cast<const Acc*>(smem_raw);
    for (int i = threadIdx.x; i < cells; i += blockDim.x) {
      Acc v = Acc(0);
      for (int c = 0; c < copies; ++c) v += base[c * cells + i];
      if (v != Acc(0)) atomicAdd(&out[i], v);
    }
  }
}

template <typename Acc, bool kWeighted>
cudaError_t launch_pair(const int* a, const int* b, const float* weights,
                        int n, int n_a, int n_b, Acc* out, int device,
                        cudaStream_t stream) {
  const size_t cells = static_cast<size_t>(n_a) * n_b;
  cudaError_t err = cudaMemsetAsync(out, 0, cells * sizeof(Acc), stream);
  if (err != cudaSuccess) return err;
  const long long want = (static_cast<long long>(n) + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  const size_t fit = kMaxSharedBytes / (cells * sizeof(Acc));
  const int copies = static_cast<int>(fit < kThreads / 32 ? fit : kThreads / 32);
  const size_t smem = static_cast<size_t>(copies) * cells * sizeof(Acc);
  auto kernel = pair_counts_kernel<Acc, kWeighted>;
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, kThreads, smem, stream>>>(a, b, weights, n, n_a, n_b,
                                             copies, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K4: a, b [n] int32 ids, weights [n] f32 or null; out [n_a, n_b], int32
// unweighted or f32 weighted, zeroed here on `stream`.
int avt_pair_counts(const void* a, const void* b, const void* weights, int n,
                    int n_a, int n_b, void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (weights != nullptr) {
    err = launch_pair<float, true>(static_cast<const int*>(a),
                                   static_cast<const int*>(b),
                                   static_cast<const float*>(weights), n, n_a,
                                   n_b, static_cast<float*>(out), device, s);
  } else {
    err = launch_pair<int, false>(static_cast<const int*>(a),
                                  static_cast<const int*>(b), nullptr, n, n_a,
                                  n_b, static_cast<int*>(out), device, s);
  }
  return static_cast<int>(err);
}

int avt_cfb_counts(const void* bins, const void* labels, const void* weights,
                   int n, int f, int c, int b, void* out, int device,
                   void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  if (weights != nullptr) {
    err = launch<float, true>(static_cast<const int*>(bins),
                              static_cast<const int*>(labels),
                              static_cast<const float*>(weights), n, f, c, b,
                              static_cast<float*>(out), device, s);
  } else {
    err = launch<int, false>(static_cast<const int*>(bins),
                             static_cast<const int*>(labels), nullptr, n, f,
                             c, b, static_cast<int*>(out), device, s);
  }
  return static_cast<int>(err);
}

const char* avt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
