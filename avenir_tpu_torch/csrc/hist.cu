// K1: Naive Bayes joint counts on Hopper (sm_90a).
//
// Replaces the TPU kernel `_cfb_kernel` (avenir_tpu/ops/pallas_histogram.py:57,
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

}  // namespace

extern "C" {

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
