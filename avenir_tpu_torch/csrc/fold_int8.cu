// K11 and K12: the int8 lane-bucket folds of the KNN kernel-restructure
// sweeps on Hopper (sm_90a).
//
// K11 replaces the int32 uses of `_tag_kernel` (scripts/sweep16_kernels.py:71
// `int8epi` and `int8aug`, scripts/sweep16b_kernels.py:77 `int8rr`). K12
// replaces `_packed_kernel` (scripts/sweep16b_kernels.py:114 `int8pk`,
// scripts/sweep16c_kernels.py:52 `int8pk8` and `int8pk16`).
//
// What they compute, for each test row r and train column col < n, over
// int8 operands xa [m][w], ya [n][w] (w = 9: quantized features; w = 19:
// -2x | 1 | 127 x 9 against y | y2 mod 127 | 9 digits of y2 div 127, so that
// the product is y2 - 2 x.y itself):
//   cross  = sum_c xa[r][c] * ya[col][c], int32 (exact in any order)
//   K11    metric = cross, or with the epilogue y2[col] - 2 * cross (y2
//          int32 [n]). Fold into B = n_acc * 128 buckets, col in bucket
//          col % B: the smallest metric strictly below INT_BIG = 2^30 and
//          the lowest column reaching it, else (INT_BIG, -1). Then k rounds
//          of extraction in (metric, column) order into out [m][128].
//   K12    packed = cross * 2048 + (col / 128), one int32 a bucket, folded
//          by min. A bucket is found where its minimum is below INT_BIG;
//          its metric is packed >> 11 (arithmetic), its column
//          (packed & 2047) * 128 + bucket % 128. The same extraction, of
//          k <= 128 candidates. The caller guarantees n <= 2^18 and
//          |cross| < 2^18. B may be 2048 (n_acc 16).
// The min over packed takes the smallest metric and, among equal metrics,
// the lowest tag, that is the lowest column of the bucket: the function of
// K11 without its epilogue.
//
// What bounds them on an H100: the per-pair integer instructions on the
// CUDA cores. The int8 product is what the tensor cores do at 1,979 TOP/s
// (2 * m * n * w operations: 0.010 ms at the bench shape and w = 19), so
// the floor is the fold that consumes each pair at 128 lanes per SM and
// clock: a compare and two selects (K11; one more for the epilogue), a
// multiply-add and a min (K12). These kernels do the product on the CUDA
// cores too, ceil(w / 4) __dp4a a pair, 5 at w = 19 and 3 at w = 9, beside
// the fold's 2 to 4. Memory is not the limit: 1.2 MB of train rows, read
// once per block from L2.
//
// Design: fold.cu's, with the operands packed four int8 to a word.
// - A block owns kR whole test rows (16, or 8 where it has 1,024 threads)
//   and sweeps all of n. It has one thread per bucket; at B = 2048 a thread
//   keeps two buckets, tid and tid + 1024.
// - A row is W4 = ceil(w / 4) words of four int8, the last padded with
//   zeros. The block's test rows sit in shared memory word-major,
//   xs[W4][kR], so a thread reads four rows of one word with one 16-byte
//   broadcast load. Each step copies B train rows, a contiguous run of
//   B * w bytes that starts on a word (B * w is a multiple of 4), into
//   shared memory as it lies, with coalesced 4-byte loads. A thread's row
//   starts at byte b * w, on no word boundary for odd w: it reads the W4 + 1
//   words that cover the row and shifts each pair into place with a funnel
//   shift, masking the pad of the last word. The caller's tensors keep the
//   sweeps' widths (9, 19); nothing is padded in device memory.
// - After the sweep the kR x B (metric, column) pairs go to shared memory
//   (K12 decodes as it writes; 128 KB at kR = 8, B = 2048) and one warp per
//   row runs the k rounds (fold_extract.cuh).
//
// Interface: plain C, bound from Python with ctypes; the caller allocates
// out_d and out_i [m][128] int32. Each entry point returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "fold_extract.cuh"

namespace {

using avt::kLanes;

constexpr int kIntBig = 1 << 30;
constexpr int kMaxW = 32;
constexpr int kPack = 2048;
constexpr int kMaxThreads = 1024;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

template <int kB>
__host__ __device__ constexpr int block_threads() {
  return kB > kMaxThreads ? kMaxThreads : kB;
}

template <int kB>
__host__ __device__ constexpr int rows_per_block() {
  return kB >= 1024 ? 8 : 16;
}

// As in fold.cu: a block of 512 threads leaves room for a second one on
// its SM (64 registers a thread; K11 took 83 without the bound).
template <int kB>
__host__ __device__ constexpr int blocks_per_sm() {
  return kB == 512 ? 2 : 1;
}

// kEpi: K11's y2 epilogue; kPacked: K12's single packed accumulator.
template <bool kEpi, bool kPacked, int kB>
__global__ void __launch_bounds__(block_threads<kB>(), blocks_per_sm<kB>())
int8_fold_kernel(const int8_t* __restrict__ xa, const int8_t* __restrict__ ya,
                 const int* __restrict__ y2, int m, int n, int w, int k,
                 int* __restrict__ out_d, int* __restrict__ out_i) {
  constexpr int kT = block_threads<kB>();
  constexpr int kP = kB / kT;  // buckets a thread
  constexpr int kR = rows_per_block<kB>();
  static_assert(kPacked || kP == 1, "only the packed fold keeps two buckets");
  extern __shared__ __align__(16) int smem[];
  const int w4 = (w + 3) >> 2;
  int* xs = smem;                                  // [w4][kR]
  int* ys = xs + static_cast<size_t>(w4) * kR;     // kB * w bytes + 2 words
  int8_t* ys_bytes = reinterpret_cast<int8_t*>(ys);
  // the bytes of a row's last word that belong to it
  const int tail = w - 4 * (w4 - 1);
  const unsigned tail_mask =
      tail == 4 ? 0xffffffffu : (1u << (8 * tail)) - 1u;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * kR;

  for (int e = tid; e < w4 * kR; e += kT) {
    const int q = e / kR;
    const int gr = row0 + (e - q * kR);
    uint32_t word = 0;
    if (gr < m) {
      for (int b = 0; b < 4 && 4 * q + b < w; ++b) {
        const uint32_t byte = static_cast<uint8_t>(
            xa[static_cast<size_t>(gr) * w + 4 * q + b]);
        word |= byte << (8 * b);
      }
    }
    xs[e] = static_cast<int>(word);
  }

  int acc_d[kP][kR];
  int acc_i[kPacked ? 1 : kR];
#pragma unroll
  for (int p = 0; p < kP; ++p) {
#pragma unroll
    for (int r = 0; r < kR; ++r) acc_d[p][r] = kIntBig;
  }
  if constexpr (!kPacked) {
#pragma unroll
    for (int r = 0; r < kR; ++r) acc_i[r] = -1;
  }

  const size_t y_len = static_cast<size_t>(n) * w;
  for (int t0 = 0; t0 < n; t0 += kB) {
    __syncthreads();  // the previous tile is fully read (first: xs written)
    const size_t base = static_cast<size_t>(t0) * w;  // a multiple of 4
    const size_t left = y_len - base;
    const int run = left < static_cast<size_t>(kB) * w
                        ? static_cast<int>(left) : kB * w;
    const int* src = reinterpret_cast<const int*>(ya + base);
    for (int e = tid; e < (run >> 2); e += kT) ys[e] = src[e];
    for (int e = (run & ~3) + tid; e < run; e += kT) {
      ys_bytes[e] = ya[base + e];  // the last tile's odd bytes
    }
    __syncthreads();
#pragma unroll
    for (int p = 0; p < kP; ++p) {
      const int b = p * kT + tid;
      const int col = t0 + b;
      if (col >= n) continue;  // a column past n never wins
      int cross[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) cross[r] = 0;
      const int byte0 = b * w;
      const int shift = 8 * (byte0 & 3);
      const int* yp = ys + (byte0 >> 2);
      unsigned lo = static_cast<unsigned>(yp[0]);
      for (int q = 0; q < w4; ++q) {
        // past a row's last word lie the next row, stale bytes or the two
        // words of slack: shifted in and masked off
        const unsigned hi = static_cast<unsigned>(yp[q + 1]);
        unsigned word = __funnelshift_r(lo, hi, shift);
        if (q == w4 - 1) word &= tail_mask;
        lo = hi;
        const int yw = static_cast<int>(word);
        const int4* xq = reinterpret_cast<const int4*>(xs + q * kR);
#pragma unroll
        for (int j = 0; j < kR / 4; ++j) {
          const int4 xv = xq[j];
          cross[4 * j] = __dp4a(xv.x, yw, cross[4 * j]);
          cross[4 * j + 1] = __dp4a(xv.y, yw, cross[4 * j + 1]);
          cross[4 * j + 2] = __dp4a(xv.z, yw, cross[4 * j + 2]);
          cross[4 * j + 3] = __dp4a(xv.w, yw, cross[4 * j + 3]);
        }
      }
      if constexpr (kPacked) {
        const int tag = col >> 7;
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          acc_d[p][r] = min(acc_d[p][r], cross[r] * kPack + tag);
        }
      } else {
        int y2v = 0;
        if constexpr (kEpi) y2v = y2[col];
#pragma unroll
        for (int r = 0; r < kR; ++r) {
          const int v = kEpi ? y2v - 2 * cross[r] : cross[r];
          if (v < acc_d[0][r]) {
            acc_d[0][r] = v;
            acc_i[r] = col;
          }
        }
      }
    }
  }

  __syncthreads();  // xs and ys are no longer read
  int* pd = smem;             // [kR][kB]
  int* pi = smem + kR * kB;   // [kR][kB]
#pragma unroll
  for (int p = 0; p < kP; ++p) {
    const int b = p * kT + tid;
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      const int v = acc_d[p][r];
      if constexpr (kPacked) {
        const bool found = v < kIntBig;
        pd[r * kB + b] = found ? v >> 11 : kIntBig;
        pi[r * kB + b] =
            found ? (v & (kPack - 1)) * kLanes + (b & (kLanes - 1)) : -1;
      } else {
        pd[r * kB + b] = v;
        pi[r * kB + b] = acc_i[r];
      }
    }
  }
  __syncthreads();

  avt::extract_rows<int, kB, kT>(pd, pi, kR, row0, m, k, kIntBig, out_d,
                                 out_i);
}

template <bool kEpi, bool kPacked, int kB>
cudaError_t launch(const int8_t* xa, const int8_t* ya, const int* y2, int m,
                   int n, int w, int k, int* out_d, int* out_i,
                   cudaStream_t stream) {
  constexpr int kR = rows_per_block<kB>();
  const size_t w4 = (static_cast<size_t>(w) + 3) / 4;
  const size_t sweep = w4 * kR + (static_cast<size_t>(kB) * w) / 4 + 2;
  const size_t extract = static_cast<size_t>(kR) * kB * 2;
  const size_t smem = (sweep > extract ? sweep : extract) * sizeof(int);
  auto kernel = int8_fold_kernel<kEpi, kPacked, kB>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<(m + kR - 1) / kR, block_threads<kB>(), smem, stream>>>(
      xa, ya, y2, m, n, w, k, out_d, out_i);
  return cudaGetLastError();
}

template <bool kEpi, bool kPacked>
cudaError_t launch_n_acc(const void* xa, const void* ya, const void* y2,
                         int m, int n, int w, int k, int n_acc, void* out_d,
                         void* out_i, int device, void* stream) {
  if (m <= 0 || n <= 0 || w <= 0 || w > kMaxW || k < 1 || k > kLanes) {
    return cudaErrorInvalidValue;
  }
  // train tiles are copied by words
  if (reinterpret_cast<uintptr_t>(ya) & 3) return cudaErrorMisalignedAddress;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int8_t* xp = static_cast<const int8_t*>(xa);
  const int8_t* yp = static_cast<const int8_t*>(ya);
  const int* y2p = static_cast<const int*>(y2);
  int* od = static_cast<int*>(out_d);
  int* oi = static_cast<int*>(out_i);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AVT_FOLD(B) \
  launch<kEpi, kPacked, B>(xp, yp, y2p, m, n, w, k, od, oi, s)
  switch (n_acc) {
    case 1: return AVT_FOLD(128);
    case 2: return AVT_FOLD(256);
    case 4: return AVT_FOLD(512);
    case 8: return AVT_FOLD(1024);
    case 16:
      if constexpr (kPacked) return AVT_FOLD(2048);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
#undef AVT_FOLD
}

}  // namespace

extern "C" {

// K11: xa [m, w], ya [n, w] int8 row-major; y2 int32 [n] or null (no
// epilogue); out_d, out_i int32 [m, 128].
int avt_fold_int8(const void* xa, const void* ya, const void* y2, int m,
                  int n, int w, int k, int n_acc, void* out_d, void* out_i,
                  int device, void* stream) {
  return static_cast<int>(
      y2 ? launch_n_acc<true, false>(xa, ya, y2, m, n, w, k, n_acc, out_d,
                                     out_i, device, stream)
         : launch_n_acc<false, false>(xa, ya, nullptr, m, n, w, k, n_acc,
                                      out_d, out_i, device, stream));
}

// K12: as K11 without y2, folded through one packed int32 a bucket; the
// caller has checked n <= 2^18 and |cross| < 2^18. n_acc may be 16.
int avt_fold_packed(const void* xa, const void* ya, int m, int n, int w,
                    int k, int n_acc, void* out_d, void* out_i, int device,
                    void* stream) {
  if (n > kPack * kLanes) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_n_acc<false, true>(
      xa, ya, nullptr, m, n, w, k, n_acc, out_d, out_i, device, stream));
}

}  // extern "C"
