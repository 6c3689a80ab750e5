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
// What bounds them on an H100: the per-pair integer instructions of the
// fold. The int8 product is what the tensor cores do at 1,979 TOP/s
// (2 * m * n * 32 operations over the padded rows: 0.017 ms at the bench
// shape), so the floor is the fold that consumes each pair: a compare and
// two selects (K11; one multiply-add more for the epilogue), a
// multiply-add and a min (K12), at 64 lanes an SM and clock, the rate
// measured for K6's compare and selects (fold.cu; 0.064 ms for K12's two
// at the bench shape, 0.096 for K11's three). Memory is not the limit:
// 1.2 MB of train rows, in the 50 MB L2. Every time below is device time
// at the bench shape (8,192 x 65,536) on an NVIDIA H100 80GB HBM3 at
// 700 W.
//
// The tensor-core body (namespace tc), K6's (fold.cu) with int8 operands:
// - A pre-pass packs ya into rows of 32 bytes, zero past w, each row's
//   eight 32-bit words in the order 0 4 1 5 2 6 3 7, so that the B
//   fragment of lane (g, tig) of mma.sync m16n8k32 (words tig and tig + 4
//   of column g) is one 8-byte load. With y2 it copies y2 beside them,
//   padded to the same rows.
// - The product is mma.sync.m16n8k32 with int8 operands and int32 sums:
//   the accumulator is the cross term, exact. A block owns 128 test rows
//   and a slice of 64 buckets (8 warps of 32 rows x 32 buckets, each two
//   m16 by four n8 tiles); the A fragments load once, before the sweep.
//   Step t brings columns t * B + the slice, so each element of a
//   thread's C fragments is one (row, bucket) pair for the whole sweep and
//   its columns come in increasing order: a strict < keeps the lowest
//   column on ties. B = 2048 is 32 slices.
// - The fold runs on the accumulator fragments. K11 keeps (value, step), a
//   compare and two selects a pair, and rebuilds the column at the end;
//   the epilogue adds one multiply-add, y2 - 2 * cross, with each n8
//   tile's two y2 values loaded as one int2 a step. K12 keeps one packed
//   int32: a multiply-add, cross * 2048 + tag, and a min, where tag = t *
//   n_acc + the slice's 128-lane group (a slice lies inside one group).
// - Pad columns: a zero train row gives cross = 0, which beats every
//   positive metric of K11 without the epilogue, and of K12: it would hide
//   a bucket's real minimum. Whole rounds of steps that hold no column
//   past n run unmasked; the rest (at most one round) mask a column past
//   n to INT_BIG before the fold.
// - The B fragments (and with the epilogue each n8 tile's y2) come from
//   the packed rows in global memory one step ahead of the fold, at
//   offsets fixed at compile time from one pointer a step. Two steps ahead
//   ran K12's sweeps 5-8% slower and K11's 2-3% faster; one value serves
//   both, so that one planner sizes the packed rows.
// - Registers: K12's pairs take 32 a thread and two blocks share an SM
//   (__launch_bounds__(256, 2), 128 registers, 8 bytes spilled). K11's take
//   64: at two blocks an SM its sweeps spilled and ran 148 us (the
//   epilogue's 176) against 145 (154) at one block an SM, where they take
//   160 and 206 registers with no spill.
// - The slices of a row tile merge through an [M, B] (metric, column)
//   scratch (K12 decodes as it writes: metric packed >> 11, column
//   (packed & 2047) * 128 + bucket % 128, or (INT_BIG, -1)), then K6's
//   extraction (fold_extract.cuh) runs the k rounds.
//
// The former CUDA-core body, kept only to be timed against the new one:
// - It does the product on the CUDA cores too, ceil(w / 4) __dp4a a pair,
//   5 at w = 19 and 3 at w = 9, beside the fold's 2 to 4.
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
// out_d and out_i [m][128] int32, and the tensor-core body's scratch. Each
// entry point returns cudaGetLastError().

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

// ---------------------------------------------------------------------------
// The tensor-core body of K11 and K12: see the note at the top.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarpRows = 32;            // two m16 tiles a warp
constexpr int kWarpCols = 32;            // four n8 tiles a warp
constexpr int kWarpsR = 4;
constexpr int kWarpsC = 2;
constexpr int kThreads = 32 * kWarpsR * kWarpsC;
constexpr int kTcRows = kWarpRows * kWarpsR;     // test rows a block
constexpr int kTcSlice = kWarpCols * kWarpsC;    // buckets a block
constexpr int kRowBytes = 32;                    // a packed train row
static_assert(kRowBytes == kMaxW, "one k-step of m16n8k32 holds a row");
static_assert(kLanes % kTcSlice == 0, "a slice lies in one lane group");

// what a sweep folds: K11's cross term, K11's y2 - 2 * cross, K12's
// packed cross * 2048 + tag
constexpr int kCross = 0;
constexpr int kEpi = 1;
constexpr int kPacked = 2;

// train steps whose fragments are in flight ahead of the one folded (two
// ran every int8 sweep 2-8% slower); the sweep runs whole rounds of
// kAhead + 1 steps
constexpr int kAhead = 1;
constexpr int kRound = kAhead + 1;

// steps of `buckets` columns the sweep runs over n train rows: whole
// rounds
__host__ __device__ inline int sweep_steps(int n, int buckets) {
  const int steps = (n + buckets - 1) / buckets;
  return (steps + kRound - 1) / kRound * kRound;
}

// rows of yp (and y2p): the sweep's steps and the kAhead its last loads
// reach past them, as ops/cuda_fold.py's int8_tc_plan sizes them
__host__ __device__ inline int padded_rows(int n, int buckets) {
  return (sweep_steps(n, buckets) + kAhead) * buckets;
}

// Packed train rows: yp [n_pad][32] bytes, row j < n holding ya[j][0..w)
// then zeros, a pad row zeros; each row's eight 32-bit words in the order
// 0 4 1 5 2 6 3 7 (lane tig's B fragment, words tig and tig + 4, is one
// 8-byte load). With y2, y2p [n_pad] holds y2 and zeros past n. One thread
// writes one row.
__global__ void pack_kernel(const int8_t* __restrict__ ya,
                            const int* __restrict__ y2, int n, int n_pad,
                            int w, uint4* __restrict__ yp,
                            int* __restrict__ y2p) {
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < n_pad;
       j += gridDim.x * blockDim.x) {
    uint32_t word[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    if (j < n) {
      const int8_t* row = ya + static_cast<size_t>(j) * w;
#pragma unroll
      for (int c = 0; c < kRowBytes; ++c) {
        if (c < w) {
          word[c >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(row[c]))
                          << (8 * (c & 3));
        }
      }
    }
    yp[2 * static_cast<size_t>(j)] =
        make_uint4(word[0], word[4], word[1], word[5]);
    yp[2 * static_cast<size_t>(j) + 1] =
        make_uint4(word[2], word[6], word[3], word[7]);
    if (y2p) y2p[j] = j < n ? y2[j] : 0;
  }
}

// c += a (16 x 32, row) * b (32 x 8, col), int8 operands, int32 sums
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint2& b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

template <bool kMasked>
struct Masked {
  static constexpr bool value = kMasked;
};

// A block owns kTcRows test rows and the buckets blockIdx.y * kTcSlice +
// [0, kTcSlice); warp column group wc takes 32 of them, n-tile j 8. Each
// element of a thread's C fragments is one (row, bucket) pair for the whole
// sweep. K11 (kCross, kEpi) keeps the smallest metric strictly below
// INT_BIG and the first step that reached it, K12 (kPacked) the smallest
// packed value. The pairs go to vals / cols [m][buckets] (K12 decoded).
template <int kFold>
__global__ void __launch_bounds__(kThreads, kFold == kPacked ? 2 : 1)
tc_int8_sweep_kernel(const int8_t* __restrict__ xa,
                     const uint2* __restrict__ yp,
                     const int* __restrict__ y2p, int m, int n, int w,
                     int n_steps, int buckets, int* __restrict__ vals,
                     int* __restrict__ cols) {
  constexpr bool kIndexed = kFold != kPacked;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp / kWarpsC;
  const int wc = warp - wr * kWarpsC;
  const int row0 = blockIdx.x * kTcRows + wr * kWarpRows;
  const int col0 = blockIdx.y * kTcSlice + wc * kWarpCols;

  // lane (g, tig) of n-tile j reads packed row t * buckets + col0 + 8 j +
  // g, its 8-byte pair tig; with the epilogue also y2 of buckets col0 + 8 j
  // + 2 tig and the next, one int2: pointers a step, offsets fixed
  const size_t step_stride = static_cast<size_t>(buckets) * (kRowBytes / 8);
  const uint2* next = yp + static_cast<size_t>(col0 + g) * (kRowBytes / 8)
                      + tig;
  const int2* next_y2 = reinterpret_cast<const int2*>(y2p + col0 + 2 * tig);
  uint2 pf[kRound][4];
  int2 py[kFold == kEpi ? kRound : 1][4];
  auto load = [&](uint2 (&dst)[4], int2 (&dy)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[j] = __ldg(next + 8 * j * (kRowBytes / 8));
      if constexpr (kFold == kEpi) dy[j] = __ldg(next_y2 + 4 * j);
    }
    next += step_stride;
    if constexpr (kFold == kEpi) next_y2 += buckets / 2;
  };
#pragma unroll
  for (int p = 0; p < kAhead; ++p) load(pf[p], py[kFold == kEpi ? p : 0]);

  // A fragments, fixed for the sweep: register h of m-tile i holds bytes
  // 4 q .. 4 q + 3 of row row0 + 16 i + g + 8 (h & 1), q = tig + 4 (h >>
  // 1); zero past w and past m
  uint32_t a[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      const int r = row0 + 16 * i + g + 8 * (h & 1);
      const int c0 = 4 * (tig + 4 * (h >> 1));
      uint32_t word = 0;
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (r < m && c0 + u < w) {
          word |= static_cast<uint32_t>(static_cast<uint8_t>(
                      xa[static_cast<size_t>(r) * w + c0 + u]))
                  << (8 * u);
        }
      }
      a[i][h] = word;
    }
  }

  int bd[2][4][4];
  int bt[kIndexed ? 2 : 1][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bd[i][j][e] = kIntBig;
        if constexpr (kIndexed) bt[i][j][e] = -1;
      }

  // K12's tag of step t: t * n_acc + the 128-lane group of the slice
  [[maybe_unused]] const int n_acc = buckets / kLanes;
  [[maybe_unused]] const int group = blockIdx.y * kTcSlice / kLanes;
  // element (j, e) at step t holds column t * buckets + 8 j + (e & 1) +
  // col0 + 2 tig: a real one while below n
  const int lim = n - col0 - 2 * tig;

  auto round = [&](int t0, auto masked) {
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      const int t = t0 + p;
      load(pf[(p + kAhead) % kRound],
           py[kFold == kEpi ? (p + kAhead) % kRound : 0]);   // t + kAhead
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          int c[4] = {0, 0, 0, 0};
          mma_s8(c, a[i], pf[p][j]);
          // element e: row g + 8 (e >> 1), bucket 8 j + 2 tig + (e & 1)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int v = c[e];
            if constexpr (kFold == kEpi) {
              v = ((e & 1) ? py[p][j].y : py[p][j].x) - 2 * v;
            } else if constexpr (kFold == kPacked) {
              v = v * kPack + (t * n_acc + group);
            }
            if constexpr (decltype(masked)::value) {
              if (t * buckets + 8 * j + (e & 1) >= lim) v = kIntBig;
            }
            if constexpr (kIndexed) {
              if (v < bd[i][j][e]) {
                bd[i][j][e] = v;
                bt[i][j][e] = t;
              }
            } else {
              bd[i][j][e] = min(bd[i][j][e], v);
            }
          }
        }
      }
    }
  };
  // rounds whose columns all lie below n, then the rest, masked
  const int open_rounds = n / buckets / kRound;
  int t0 = 0;
  for (int q = 0; q < open_rounds; ++q, t0 += kRound) {
    round(t0, Masked<false>());
  }
  for (; t0 < n_steps; t0 += kRound) round(t0, Masked<true>());

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int bucket = col0 + 8 * j + 2 * tig;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + g + 8 * h;
        if (r >= m) continue;
        const size_t at = static_cast<size_t>(r) * buckets + bucket;
        int d[2];
        int col[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int v = bd[i][j][2 * h + u];
          if constexpr (kIndexed) {
            const int t = bt[i][j][2 * h + u];
            d[u] = v;
            col[u] = t < 0 ? -1 : t * buckets + bucket + u;
          } else {
            const bool found = v < kIntBig;
            d[u] = found ? v >> 11 : kIntBig;
            col[u] = found ? (v & (kPack - 1)) * kLanes
                                 + ((bucket + u) & (kLanes - 1))
                           : -1;
          }
        }
        *reinterpret_cast<int2*>(vals + at) = make_int2(d[0], d[1]);
        *reinterpret_cast<int2*>(cols + at) = make_int2(col[0], col[1]);
      }
    }
  }
}

int grid_for(size_t work) {
  return static_cast<int>(work / 256 + 1 < 4096 ? work / 256 + 1 : 4096);
}


// Pack, sweep and k rounds over buckets = n_acc * 128 buckets; yp, y2p
// (with y2 only), vals and cols are the caller's scratch: [padded_rows][32]
// bytes, [padded_rows] and [m][buckets] int32.
template <int kFold>
cudaError_t fold(const int8_t* xa, const int8_t* ya, const int* y2, int m,
                 int n, int w, int k, int buckets, uint4* yp, int* y2p,
                 int* vals, int* cols, int* out_d, int* out_i,
                 cudaStream_t s) {
  const int n_pad = padded_rows(n, buckets);
  pack_kernel<<<grid_for(static_cast<size_t>(n_pad)), 256, 0, s>>>(
      ya, y2, n, n_pad, w, yp, kFold == kEpi ? y2p : nullptr);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((m + kTcRows - 1) / kTcRows, buckets / kTcSlice);
  tc_int8_sweep_kernel<kFold><<<grid, kThreads, 0, s>>>(
      xa, reinterpret_cast<const uint2*>(yp), y2p, m, n, w,
      sweep_steps(n, buckets), buckets, vals, cols);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
#define AVT_EXTRACT(B) \
  avt::tc_extract<int, B>(vals, cols, m, k, kIntBig, out_d, out_i, s)
  switch (buckets) {
    case 128: return AVT_EXTRACT(128);
    case 256: return AVT_EXTRACT(256);
    case 512: return AVT_EXTRACT(512);
    case 1024: return AVT_EXTRACT(1024);
    case 2048: return AVT_EXTRACT(2048);
    default: return cudaErrorInvalidValue;
  }
#undef AVT_EXTRACT
}

}  // namespace tc

// the sizes a tensor-core launch takes; n_acc 16 for K12 only
bool tc_sizes_ok(int m, int n, int w, int k, int n_acc, bool packed) {
  return m > 0 && n > 0 && w > 0 && w <= kMaxW && k >= 1 && k <= kLanes &&
         (n_acc == 1 || n_acc == 2 || n_acc == 4 || n_acc == 8 ||
          (packed && n_acc == 16));
}

}  // namespace

extern "C" {

// K11: xa [m, w], ya [n, w] int8 row-major; y2 int32 [n] or null (no
// epilogue); out_d, out_i int32 [m, 128]. body 0: the CUDA-core body; 1:
// the tensor cores, with the caller's scratch yp, y2p (with y2 only), vals,
// cols (see tc::fold).
int avt_fold_int8(const void* xa, const void* ya, const void* y2, int m,
                  int n, int w, int k, int n_acc, int body, void* yp,
                  void* y2p, void* vals, void* cols, void* out_d, void* out_i,
                  int device, void* stream) {
  if (body == 0) {
    return static_cast<int>(
        y2 ? launch_n_acc<true, false>(xa, ya, y2, m, n, w, k, n_acc, out_d,
                                       out_i, device, stream)
           : launch_n_acc<false, false>(xa, ya, nullptr, m, n, w, k, n_acc,
                                        out_d, out_i, device, stream));
  }
  if (body != 1 || !tc_sizes_ok(m, n, w, k, n_acc, false)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const auto* xp = static_cast<const int8_t*>(xa);
  const auto* yp8 = static_cast<const int8_t*>(ya);
  const auto* y2i = static_cast<const int*>(y2);
  auto s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      y2 ? tc::fold<tc::kEpi>(xp, yp8, y2i, m, n, w, k, n_acc * kLanes,
                              static_cast<uint4*>(yp), static_cast<int*>(y2p),
                              static_cast<int*>(vals), static_cast<int*>(cols),
                              static_cast<int*>(out_d),
                              static_cast<int*>(out_i), s)
         : tc::fold<tc::kCross>(xp, yp8, nullptr, m, n, w, k, n_acc * kLanes,
                                static_cast<uint4*>(yp), nullptr,
                                static_cast<int*>(vals),
                                static_cast<int*>(cols),
                                static_cast<int*>(out_d),
                                static_cast<int*>(out_i), s));
}

// K12: as K11 without y2, folded through one packed int32 a bucket; the
// caller has checked n <= 2^18 and |cross| < 2^18. n_acc may be 16. body 0:
// the CUDA-core body; 1: the tensor cores, with the caller's scratch yp,
// vals, cols.
int avt_fold_packed(const void* xa, const void* ya, int m, int n, int w,
                    int k, int n_acc, int body, void* yp, void* vals,
                    void* cols, void* out_d, void* out_i, int device,
                    void* stream) {
  if (n > kPack * kLanes) return static_cast<int>(cudaErrorInvalidValue);
  if (body == 0) {
    return static_cast<int>(launch_n_acc<false, true>(
        xa, ya, nullptr, m, n, w, k, n_acc, out_d, out_i, device, stream));
  }
  if (body != 1 || !tc_sizes_ok(m, n, w, k, n_acc, true)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tc::fold<tc::kPacked>(
      static_cast<const int8_t*>(xa), static_cast<const int8_t*>(ya),
      nullptr, m, n, w, k, n_acc * kLanes, static_cast<uint4*>(yp), nullptr,
      static_cast<int*>(vals), static_cast<int*>(cols),
      static_cast<int*>(out_d), static_cast<int*>(out_i),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
