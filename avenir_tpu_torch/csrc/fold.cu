// K6-K10: the lane-bucket fold of the KNN experiment kernels on Hopper
// (sm_90a).
//
// K6 replaces `_acc_kernel` (scripts/exp_fold.py:24, launched from
// `acc_topk` at :91). K7 replaces `_dotmin_kernel`, K8 `_nodot_kernel` and
// K9 `_tpose_kernel` (scripts/roofline_knn.py:75, :98, :142, launched at
// :205, :255 and :225). K10 replaces the f32 uses of `_tag_kernel` without
// an epilogue (scripts/sweep16_kernels.py:71 `augbf16`,
// scripts/sweep16b_kernels.py:77 `augv2`) and `_tpose_aug_kernel`
// (scripts/sweep18_tpose_fold.py:110). Two bodies serve the five (below):
// the tensor-core body (K6 with bf16 rounding, K7, K9, K10; K8 on its
// tile) and the CUDA-core template of PRs 3-4, with compile-time flags for
// the layout (row-major or feature-major operands), the metric (a product
// or a broadcast; with or without the y2 epilogue) and the output (indexed
// or values only). The TPU's scalar-tag index fold is no different function
// here: both bodies visit a bucket's columns in increasing order, so the
// column is rebuilt from the step whether the TPU kept an iota or a tag.
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
//           of bf16 values are exact in f32; the tensor cores sum them in
//           their own order, the plain version in feature order, c = 0,
//           1, ... (the y2 columns are some 2^8 times the others, so the
//           order shows in the last bits): the two agree within 1e-5
//           relative, columns differing at near-ties only, and exactly on
//           integer operands. Row-major or feature-major.
// Indexed kernels fold into B = n_acc * 128 buckets, col falling in bucket
// col % B: each bucket keeps the smallest metric strictly below BIG and the
// lowest column reaching it, else (BIG, -1). Then k rounds extract, per
// row, the smallest (value, column) pair in (value, column) order, masking
// the pair taken, into out [m][128]; slots past k hold (BIG, -1).
//
// What bounds them on an H100: the per-pair instructions on the CUDA cores.
// A product of bf16-rounded operands summed in f32 is what the tensor cores
// do at 989 TFLOP/s (2 * m * n * d flops: 0.010 ms at the bench shape), so
// the floor of K6, K7, K9 and K10 is the fold that consumes each pair: the
// metric, a compare and two selects (K7: the metric and a min), at 128
// lanes per SM and clock; K8 has no product and the same fold. Memory is
// not the limit: the train set is 2.4 MB at the bench shape, in the 50 MB
// L2. Two bodies serve them.
//
// The tensor-core body (namespace tc): K6 with its round flag on, K7, K9
// and K10; K8 runs its tile with an add for the product. Every time below is
// chained device time at the bench shape (8,192 x 65,536 x 9) on an NVIDIA
// H100 80GB HBM3 at 700 W.
// - The product is mma.sync m16n8k16 (bf16 operands, f32 sums) with y2 in
//   the padding of k: A = [-2 bf16(x) | 1 1 1 | 0] against packed train
//   rows [bf16(y) | y2 in three bf16 parts, an exact split | 0], so the
//   accumulator is the metric and the fold spends a compare and two
//   selects a pair (K7 one min). d + 3 <= 16 is one k-step (d <= 13),
//   d = 48 four. The products are exact in f32; only the order of the sum
//   differs from the CUDA cores'. A pre-pass packs y (tc::pack_kernel; its
//   time is in the kernel's). Pad columns carry the largest finite bf16 as
//   y2, a metric above BIG that never wins.
// - A block owns R = 128 test rows and a slice of B' = 64 buckets (8 warps
//   of 32 rows x 32 buckets, each warp two m16 by four n8 tiles). Step t
//   brings columns t * B + the slice, so each element of a thread's C
//   fragments is one (row, bucket) pair for the whole sweep and columns
//   come in increasing order: a strict < keeps the lowest column on ties.
//   The thread stores the step, not the column, which it rebuilds at the
//   end.
// - Two limits size the tile. Re-reads of y: every row tile reads all the
//   packed rows, M / R * N * 32 bytes = 134 MB from L2 at the bench shape
//   (the CUDA-core body, R = 16 and f32 rows: 1.34 GB). Registers: K6's
//   pairs take 128 * 64 * 2 words / 256 threads = 64 registers a thread;
//   all 512 buckets of 128 rows would fill the SM's register file alone.
//   At one or two k-steps __launch_bounds__(256, 2) holds a thread to 128
//   registers so that two blocks share an SM (ptxas: K6 128 with 28-36
//   bytes spilled, one spill access inside the loop; K7 126 and 128); at
//   three or four, one block (K6 214 and 238, K7 164 and 182). One block
//   an SM at one k-step, no spills, ran K6's sweep 0.1355 ms against
//   0.1348-0.1363 at 512 buckets and 0.1503 against 0.1421 at 1024, K7's
//   0.0662 against 0.0582-0.0585.
// - K6's slices of a row tile merge through an [M, B] (metric, column)
//   scratch, then tc_extract_kernel (fold_extract.cuh, shared with K11 and
//   K12) runs the k rounds, a warp a row (at n_acc 4 the sweep takes 140
//   us, the extraction 18, the pack 3-4). Measured and left out: a thread
//   block cluster of the B / B' blocks of a row tile trading pairs through
//   distributed shared memory, the k rounds in the sweep kernel (0.2155
//   ms against 0.1824-0.1827 at n_acc 4, slower at 2 and 8 too); each
//   quad of lanes writing only the min(k, 32) smallest of its row's 32
//   buckets (80 of 512 at k = 5: the extraction 18.2 -> 17.2 us, the
//   sweep 139.9 -> 148.1).
// - The B fragments come straight from the packed rows in global memory,
//   two steps ahead of the fold (one at more than one k-step), one 8-byte
//   load a lane, n8 tile and k-step (the packing orders each k-step's
//   words 0 4 1 5 2 6 3 7 for it), at offsets fixed at compile time from
//   one pointer a step; L1 serves the four warps that share a column
//   group. The sweep runs whole rounds of three steps (two) over rows
//   padded for it, so its loop tests no bound. A cp.async ring of 2-step
//   stages read by ldmatrix, a barrier a stage, ran 0.1635 ms against
//   0.1505 for K6's sweep, 0.0926 against 0.0708 for K7's (8-step stages:
//   0.1586, 0.0849). Computing each load's address and testing the bound
//   a step (218 IMAD and 80 ISETP for 24 HMMA) had held K6 at 0.1745 ms,
//   0.1631 without.
// - K7 folds 512 buckets, four a lane, and a block's 64 are the four of
//   16 lanes, so each thread takes its lanes' minima in registers and
//   writes the output (0.0695 -> 0.0622 ms against a scratch and a
//   lane-minimum kernel). 128 buckets, one a lane, gave 128 blocks, one an
//   SM: 0.0961-0.0979 ms against 0.0818-0.0822 then.
// - What sets the pace: the compare, selects and minimum run at 64 lanes
//   an SM and clock, half the FP32 rate. Without loads K6's sweep ran
//   0.131 ms and K7's 0.057, 0.074 ms apart for K6's two more of them a
//   pair; mma.sync peaked at 654 TFLOP/s (2 * m * n * 16 flops: 0.026 ms).
// - K9 is K6's function over feature-major operands, xt [d][m] and yt
//   [d][n]: the pack and the A fragments read them through run-time
//   strides (Strides; K6 (d, 1), K9 (1, rows)), both outside the sweep's
//   loop, so K9 runs K6's sweep and extraction instantiations as they
//   are. The pack's reads of yt are coalesced across a warp (consecutive
//   rows) and take 5.5-5.7 us against K6's 4.3: K9 0.1643-0.1651 ms at
//   n_acc 4 (K6 0.1622-0.1626), 0.1953-0.1963 at n_acc 8; its CUDA-core
//   body 0.625-0.635 and 0.658-0.666.
// - K10 is the body's raw mode (kRaw in pack_kernel and tc_sweep_kernel,
//   compile-time, so that K6's, K7's and K9's instantiations keep their
//   code): A = [bf16(x) | 1 1 1 | 0] against rows packed as [bf16(y) |
//   0 0 0 | 0], so the accumulator is the raw metric and real columns take
//   +0 from the padding, which changes no f32 sum. A pad row is 0 but for
//   kPadY2 against the first 1, as K6's: its metric, 3.39e38, lies above
//   BIG and never wins, with no bound test and no mask in the loop. ksteps
//   stays (W + 3 + 15) / 16, K6's, so the planner, the packed layout and
//   the sweep's instantiations (tc_sweep_kernel<true, S, true>) follow
//   K6's; one pad column would save a k-step at W = 14 and 15 only, and
//   the sweeps run W = 10 and 11 (one k-step). Masking the columns past N
//   in the last round, as the int8 body does (fold_int8.cu), was the
//   alternative: the int8 body must, since no int8 operand puts a pad's
//   metric above every real one, whereas a bf16 pad value does that here
//   for free. The feature-major arm (tpose_aug, [W][rows]) reads x and y
//   through K9's strides and runs the same instantiations as augv2. K10
//   runs 0.1692 ms (augbf16), 0.1695-0.1699 (augv2) and 0.1609-0.1615
//   (tpose_aug) against its CUDA-core body's 0.854, 0.909-0.917 and 0.619:
//   the sweep 133.5 us, as K6's, the extraction 17.7, the pack 2.9-3.1
//   (5.7 strided), and 8.3 for widening the bf16 tensors augbf16 and
//   augv2 arrive in.
// - K8 (tc_nodot_kernel) is the sweep's tile with the product replaced by
//   one add: the element of a thread's fragments for (row r, bucket b) at
//   step t is y2p[t * B + b] + s[r], four row sums in registers, four
//   float2 of y2p a step loaded ahead as the B fragments are, then K6's
//   fold and extraction; the wrapper pads y2 with +inf, so the loop tests
//   no bound. One f32 add of the same two values as the plain version and
//   the columns in the same order: K8 equals it bit for bit. It runs
//   0.1432-0.1446 ms (sweep 116 us, extraction 18, pad 3) against the
//   CUDA-core body's 0.2045-0.2081: the sweep's floor is its compare and
//   two selects at 64 lanes, 0.096 ms.
//
// The CUDA-core body: K6 with its round flag off (f32 operands cannot
// pass the bf16 tensor cores unchanged); K8, K9 and K10 keep it to be
// timed against. It does the product on the CUDA cores, d FMAs a pair
// beside the fold's 4, so it can reach at most 4 / (d + 4) of the floor;
// K10's fold spends 3 (no epilogue) beside W FMAs. Where the TPU grid
// carries its accumulators across train tiles in VMEM, a Hopper block owns
// kR whole test rows and sweeps all of n itself.
// - A block has B threads, one per bucket, and kR test rows: 16, or 8 at
//   B = 1024 where a thread may hold only 64 registers. The rows' features
//   sit in shared memory, d-major, so a thread reads four rows of one
//   feature with one 16-byte broadcast load.
// - Thread b visits columns b, b + B, b + 2B, ... in increasing order; a
//   strict < gives the lowest column on ties for free. It keeps its kR
//   (value, column) pairs in registers.
// - Row-major operands (K6, K10): each step stages B train rows of y, a
//   contiguous run of B * d floats, into shared memory with coalesced loads;
//   a thread then reads its row at stride d, free of bank conflicts for odd
//   d. Feature-major operands (K9, K10): thread b reads yt[c][col] straight
//   from global memory, coalesced across the warp, with no staging and no
//   barrier.
// - After the sweep the kR x B pairs go to shared memory (at most 64 KB);
//   one warp per row runs the k rounds (fold_extract.cuh).
// - K7's former body, kept to time against: K6's block of 512 (four
//   buckets a lane, one minimum each, no column), then each lane's minimum
//   of its four.
//
// Interface: plain C, bound from Python with ctypes; the caller allocates
// out_d (and out_i) [m][128]. Each entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

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

// ---------------------------------------------------------------------------
// The tensor-core body of K6 (bf16 on), K7, K9 and K10, and K8 on its
// tile: see the note at the top.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int kWarpRows = 32;            // two m16 tiles a warp
constexpr int kWarpCols = 32;            // four n8 tiles a warp
constexpr int kWarpsR = 4;
constexpr int kWarpsC = 2;
constexpr int kThreads = 32 * kWarpsR * kWarpsC;
constexpr int kTcRows = kWarpRows * kWarpsR;     // R, test rows a block
constexpr int kTcSlice = kWarpCols * kWarpsC;    // B', buckets a block
constexpr int kDotminBuckets = 512;              // K7: four buckets a lane
constexpr unsigned short kPadY2 = 0x7F7F;        // largest finite bf16

// Where an operand of rows i and features c keeps element (i, c): at
// i * row + c * feat, so (d, 1) row-major and (1, rows) feature-major
// ([d][rows]). Only the pack and the A fragments read through it, both
// outside the sweep's loop.
struct Strides {
  int row;
  int feat;
  __host__ __device__ size_t at(int i, int c) const {
    return static_cast<size_t>(i) * row + static_cast<size_t>(c) * feat;
  }
};

// k-steps of 16 for d features and the three y2 parts
__host__ __device__ constexpr int ksteps(int d) { return (d + 3 + 15) / 16; }
// train steps whose fragments are in flight ahead of the one folded; the
// sweep runs whole rounds of steps_ahead + 1 steps
__host__ __device__ constexpr int steps_ahead(int kSteps) {
  return kSteps == 1 ? 2 : 1;
}

// steps of `buckets` columns the sweep runs over n train rows: whole
// rounds, so that its loop has no bound to test (pad columns never win)
__host__ __device__ inline int sweep_steps(int n, int d, int buckets) {
  const int round = steps_ahead(ksteps(d)) + 1;
  const int steps = (n + buckets - 1) / buckets;
  return (steps + round - 1) / round * round;
}

// rows of yp: the sweep's steps and the steps_ahead its last loads reach
// past them, as ops/cuda_fold.py's tc_plan sizes it
__host__ __device__ inline int padded_rows(int n, int d, int buckets) {
  return (sweep_steps(n, d, buckets) + steps_ahead(ksteps(d))) * buckets;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint2& b) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Packed train rows: yp [n_pad][16 * ksteps(d)] bf16. Logically row j < n
// holds bf16(y[j][0..d)), then y2[j] split exactly into three bf16 parts
// (kRaw, K10: zeros; y2 is not read), then zeros; a pad row holds zeros
// but for kPadY2 in column d, so that its metric lies above BIG. In memory
// each k-step's eight 32-bit words (two values each) lie in the order 0 4
// 1 5 2 6 3 7, so that the B fragment of lane (g, tig), words tig and tig
// + 4 of row g, is one 8-byte load. One thread writes one k-step of a row
// (32 bytes).
template <bool kRaw>
__global__ void pack_kernel(const float* __restrict__ y, Strides ys,
                            const float* __restrict__ y2, int n, int n_pad,
                            int d, int steps, uint4* __restrict__ yp) {
  const size_t total = static_cast<size_t>(n_pad) * steps;
  for (size_t e = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       e < total; e += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const int j = static_cast<int>(e / steps);
    const int c0 = static_cast<int>(e % steps) * 16;
    float part[3] = {0.f, 0.f, 0.f};
    if (!kRaw && j < n) {
      const float s = y2[j];
      part[0] = bf16_round(s);
      const float r = s - part[0];         // exact
      part[1] = bf16_round(r);
      part[2] = r - part[1];               // exact, and exact in bf16
    }
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      float v[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int c = c0 + 2 * q + u;
        v[u] = j >= n ? 0.f
               : c < d ? y[ys.at(j, c)]
               : c < d + 3 ? part[c - d] : 0.f;
      }
      w[q] = pack_bf16x2(v[0], v[1]);
      if (j >= n && (c0 + 2 * q == d || c0 + 2 * q + 1 == d)) {
        w[q] |= static_cast<uint32_t>(kPadY2) << (16 * (d & 1));
      }
    }
    yp[2 * e] = make_uint4(w[0], w[4], w[1], w[5]);
    yp[2 * e + 1] = make_uint4(w[2], w[6], w[3], w[7]);
  }
}

// A thread's (row, bucket) pairs of a K6 or K8 sweep into vals / cols
// [m][buckets]: the metric and the column t * buckets + bucket of the step
// t that reached it, or -1. Element e of n-tile j of m-tile i is row
// row0 + 16 i + g + 8 (e >> 1), bucket col0 + 8 j + 2 tig + (e & 1).
__device__ __forceinline__ void store_pairs(
    const float (&bd)[2][4][4], const int (&bt)[2][4][4], int row0, int col0,
    int g, int tig, int m, int buckets, float* __restrict__ vals,
    int* __restrict__ cols) {
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
        *reinterpret_cast<float2*>(vals + at) =
            make_float2(bd[i][j][2 * h], bd[i][j][2 * h + 1]);
        const int t0 = bt[i][j][2 * h];
        const int t1 = bt[i][j][2 * h + 1];
        *reinterpret_cast<int2*>(cols + at) =
            make_int2(t0 < 0 ? -1 : t0 * buckets + bucket,
                      t1 < 0 ? -1 : t1 * buckets + bucket + 1);
      }
    }
  }
}

// A block owns kTcRows test rows and kTcSlice of the `buckets` buckets;
// step t brings the train columns t * buckets + those buckets. K6: the
// buckets blockIdx.y * kTcSlice + [0, kTcSlice), warp column group wc
// taking 32 of them, n-tile j 8. K7 (kDotminBuckets, four a lane): the
// four buckets of lanes blockIdx.y * 16 + [0, 16), warp column group wc
// taking 8 lanes, n-tile j the buckets 128 j + those lanes, so that a
// thread holds all four buckets of its lanes and writes their minimum. Each element of a thread's C
// fragments is one (row, bucket) pair for the whole sweep: it keeps the
// smallest metric strictly below BIG and the first step that reached it.
// The B fragments come straight from the packed rows (L1 serves the four
// warps of a column group), steps_ahead() steps ahead of the fold.
// K6 writes its (metric, column) pairs to vals / cols [m][buckets]; K7
// its lane minima to vals [m][128]. kRaw (K10, indexed): the A fragments
// carry bf16(x) in place of -2 bf16(x), against rows packed without y2.
template <bool kIndexed, int kSteps, bool kRaw>
__global__ void __launch_bounds__(kThreads, kSteps <= 2 ? 2 : 1)
tc_sweep_kernel(const float* __restrict__ x, Strides xs,
                const uint2* __restrict__ yp, int m, int d, int n_steps,
                int buckets,
                float* __restrict__ vals, int* __restrict__ cols) {
  constexpr int kAhead = steps_ahead(kSteps);
  constexpr int kRound = kAhead + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp / kWarpsC;
  const int wc = warp - wr * kWarpsC;
  const int row0 = blockIdx.x * kTcRows + wr * kWarpRows;
  const int slice0 = blockIdx.y * kTcSlice;

  // lane (g, tig) of n-tile j reads column t * buckets + col0 + g +
  // kTileCols j, words 2 tig and 2 tig + 1 of each k-step: a pointer a
  // step and offsets fixed at compile time
  constexpr int kTileCols = kIndexed ? 8 : kLanes;
  const int col0 = kIndexed ? slice0 + wc * kWarpCols
                            : blockIdx.y * (kTcSlice / 4) + wc * 8;
  const size_t step_stride = static_cast<size_t>(buckets) * kSteps * 4;
  const uint2* next =
      yp + (static_cast<size_t>(col0 + g) * kSteps) * 4 + tig;
  uint2 pf[kRound][4][kSteps];
  auto load = [&](uint2 (&dst)[4][kSteps]) {
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < kSteps; ++q)
        dst[j][q] = __ldg(next + (kTileCols * j * kSteps + q) * 4);
    next += step_stride;
  };
#pragma unroll
  for (int p = 0; p < kAhead; ++p) load(pf[p]);

  // A fragments, fixed for the sweep: -2 bf16(x) (kRaw: bf16(x)), then 1
  // against the three y2 parts, then 0; rows past m are 0. K7 reads
  // row-major x only:
  // with its strides fixed ptxas schedules its loop as before the strides
  // (0.0622 ms at the bench shape against 0.0655 through xs)
  const Strides ax = kIndexed ? xs : Strides{d, 1};
  uint32_t a[2][kSteps][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int q = 0; q < kSteps; ++q) {
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        const int r = row0 + 16 * i + g + 8 * (h & 1);
        const int c = 16 * q + 2 * tig + 8 * (h >> 1);
        float v[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int cu = c + u;
          v[u] = r >= m ? 0.f
                 : cu < d ? (kRaw ? 1.f : -2.f) * x[ax.at(r, cu)]
                 : cu < d + 3 ? 1.f : 0.f;
        }
        a[i][q][h] = pack_bf16x2(v[0], v[1]);
      }
    }
  }

  float bd[2][4][4];
  int bt[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bd[i][j][e] = kBig;
        bt[i][j][e] = -1;
      }

  for (int t0 = 0; t0 < n_steps; t0 += kRound) {
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      const int t = t0 + p;
      load(pf[(p + kAhead) % kRound]);   // step t + kAhead
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float c[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int q = 0; q < kSteps; ++q) mma_bf16(c, a[i][q], pf[p][j][q]);
          // element e: row g + 8 (e >> 1), bucket 2 tig + (e & 1)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if constexpr (kIndexed) {
              if (c[e] < bd[i][j][e]) {
                bd[i][j][e] = c[e];
                bt[i][j][e] = t;
              }
            } else {
              bd[i][j][e] = fminf(bd[i][j][e], c[e]);
            }
          }
        }
      }
    }
  }

  if constexpr (!kIndexed) {
    // lane col0 + 2 tig + (e & 1): the minimum of its four buckets
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = row0 + 16 * i + g + 8 * h;
        if (r >= m) continue;
        float lo = bd[i][0][2 * h];
        float hi = bd[i][0][2 * h + 1];
#pragma unroll
        for (int j = 1; j < 4; ++j) {
          lo = fminf(lo, bd[i][j][2 * h]);
          hi = fminf(hi, bd[i][j][2 * h + 1]);
        }
        *reinterpret_cast<float2*>(
            vals + static_cast<size_t>(r) * kLanes + col0 + 2 * tig) =
            make_float2(lo, hi);
      }
    }
    return;
  }
  store_pairs(bd, bt, row0, col0, g, tig, m, buckets, vals, cols);
}

// K8 on the tile of tc_sweep_kernel, the product replaced by an add: the
// element of a thread's fragments for (row r, bucket b) at step t is
// y2p[t * buckets + b] + s[r], s[r] the sum of row r's features in feature
// order (as fold.row_sum). y2p is y2 padded with +inf to padded_rows(n, d,
// buckets) entries, so the loop tests no bound and a pad never wins. A
// thread holds the sums of its four rows and loads its eight buckets' y2
// as four float2 a step, kAhead steps ahead of the fold; a pair costs an
// add, a compare and two selects, and the step is stored, not the column.
// Its pairs go to vals / cols [m][buckets] as K6's do.
template <int kAhead>
__global__ void __launch_bounds__(kThreads, 2)
tc_nodot_kernel(const float* __restrict__ x, const float* __restrict__ y2p,
                int m, int d, int n_steps, int buckets,
                float* __restrict__ vals, int* __restrict__ cols) {
  constexpr int kRound = kAhead + 1;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int wr = warp / kWarpsC;
  const int wc = warp - wr * kWarpsC;
  const int row0 = blockIdx.x * kTcRows + wr * kWarpRows;
  const int col0 = blockIdx.y * kTcSlice + wc * kWarpCols;

  // buckets col0 + 8 j + 2 tig and the next: one float2 of y2p a step
  const float2* next = reinterpret_cast<const float2*>(y2p + col0 + 2 * tig);
  const int step_stride = buckets / 2;
  float2 pf[kRound][4];
  auto load = [&](float2 (&dst)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) dst[j] = __ldg(next + 4 * j);
    next += step_stride;
  };
#pragma unroll
  for (int p = 0; p < kAhead; ++p) load(pf[p]);

  // s[i][h]: row row0 + 16 i + g + 8 h (0 past m)
  float s[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + 16 * i + g + 8 * h;
      float v = 0.f;
      if (r < m) {
        for (int c = 0; c < d; ++c) v += x[static_cast<size_t>(r) * d + c];
      }
      s[i][h] = v;
    }
  }

  float bd[2][4][4];
  int bt[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        bd[i][j][e] = kBig;
        bt[i][j][e] = -1;
      }

  for (int t0 = 0; t0 < n_steps; t0 += kRound) {
#pragma unroll
    for (int p = 0; p < kRound; ++p) {
      const int t = t0 + p;
      load(pf[(p + kAhead) % kRound]);   // step t + kAhead
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float v =
                ((e & 1) ? pf[p][j].y : pf[p][j].x) + s[i][e >> 1];
            if (v < bd[i][j][e]) {
              bd[i][j][e] = v;
              bt[i][j][e] = t;
            }
          }
        }
      }
    }
  }
  store_pairs(bd, bt, row0, col0, g, tig, m, buckets, vals, cols);
}

int grid_for(size_t work) {
  return static_cast<int>(work / 256 + 1 < 4096 ? work / 256 + 1 : 4096);
}

template <bool kRaw>
cudaError_t pack(const float* y, Strides ys, const float* y2, int n,
                 int n_pad, int d, uint4* yp, cudaStream_t s) {
  const int steps = ksteps(d);
  pack_kernel<kRaw>
      <<<grid_for(static_cast<size_t>(n_pad) * steps), 256, 0, s>>>(
          y, ys, y2, n, n_pad, d, steps, yp);
  return cudaGetLastError();
}

template <bool kIndexed, int kSteps, bool kRaw>
cudaError_t sweep(const float* x, Strides xs, const uint4* yp, int m, int d,
                  int n, int buckets, float* vals, int* cols,
                  cudaStream_t s) {
  const dim3 grid((m + kTcRows - 1) / kTcRows, buckets / kTcSlice);
  tc_sweep_kernel<kIndexed, kSteps, kRaw><<<grid, kThreads, 0, s>>>(
      x, xs, reinterpret_cast<const uint2*>(yp), m, d,
      sweep_steps(n, d, buckets), buckets, vals, cols);
  return cudaGetLastError();
}

template <bool kIndexed, bool kRaw>
cudaError_t sweep_any(const float* x, Strides xs, const uint4* yp, int m,
                      int d, int n, int buckets, float* vals, int* cols,
                      cudaStream_t s) {
#define AVT_SWEEP(S) \
  sweep<kIndexed, S, kRaw>(x, xs, yp, m, d, n, buckets, vals, cols, s)
  switch (ksteps(d)) {
    case 1: return AVT_SWEEP(1);
    case 2: return AVT_SWEEP(2);
    case 3: return AVT_SWEEP(3);
    case 4: return AVT_SWEEP(4);
    default: return cudaErrorInvalidValue;
  }
#undef AVT_SWEEP
}


// the k rounds over [m][buckets] (metric, column) pairs (fold_extract.cuh)
cudaError_t extract_any(const float* vals, const int* cols, int m, int k,
                        int buckets, float* out_d, int* out_i,
                        cudaStream_t s) {
#define AVT_EXTRACT(B) \
  avt::tc_extract<float, B>(vals, cols, m, k, kBig, out_d, out_i, s)
  switch (buckets) {
    case 128: return AVT_EXTRACT(128);
    case 256: return AVT_EXTRACT(256);
    case 512: return AVT_EXTRACT(512);
    case 1024: return AVT_EXTRACT(1024);
    default: return cudaErrorInvalidValue;
  }
#undef AVT_EXTRACT
}

// K6, K9 and (kRaw, y2 unread) K10 on the tensor cores: pack, sweep, k
// rounds, the operands read through xs and ys (row-major or feature-major).
// yp, vals and cols are the caller's scratch: [padded_rows][16 ksteps(d)]
// bf16, [m][buckets] f32 and i32.
template <bool kRaw>
cudaError_t fold_acc(const float* x, Strides xs, const float* y, Strides ys,
                     const float* y2, int m, int n, int d, int k,
                     int buckets, uint4* yp, float* vals, int* cols,
                     float* out_d, int* out_i, cudaStream_t s) {
  cudaError_t err =
      pack<kRaw>(y, ys, y2, n, padded_rows(n, d, buckets), d, yp, s);
  if (err != cudaSuccess) return err;
  err = sweep_any<true, kRaw>(x, xs, yp, m, d, n, buckets, vals, cols, s);
  if (err != cudaSuccess) return err;
  return extract_any(vals, cols, m, k, buckets, out_d, out_i, s);
}

// K8 on the tile of the tensor-core sweep without the product: the sweep
// over y2p, y2 padded with +inf to padded_rows(n, d, buckets) entries by
// the caller, then K6's k rounds; vals and cols are the caller's scratch.
cudaError_t fold_nodot(const float* x, const float* y2p, int m, int n,
                       int d, int k, int buckets, float* vals, int* cols,
                       float* out_d, int* out_i, cudaStream_t s) {
  const dim3 grid((m + kTcRows - 1) / kTcRows, buckets / kTcSlice);
  const int n_steps = sweep_steps(n, d, buckets);
  if (steps_ahead(ksteps(d)) == 2) {
    tc_nodot_kernel<2><<<grid, kThreads, 0, s>>>(x, y2p, m, d, n_steps,
                                                   buckets, vals, cols);
  } else {
    tc_nodot_kernel<1><<<grid, kThreads, 0, s>>>(x, y2p, m, d, n_steps,
                                                   buckets, vals, cols);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return extract_any(vals, cols, m, k, buckets, out_d, out_i, s);
}

// K7 on the tensor cores over kDotminBuckets buckets, four a lane, each
// thread writing its lanes' minima; yp is the caller's scratch.
cudaError_t fold_dotmin(const float* x, const float* y, const float* y2,
                        int m, int n, int d, uint4* yp, float* out_d,
                        cudaStream_t s) {
  static_assert(kDotminBuckets == 4 * kLanes && kTcSlice == 4 * 16,
                "a K7 block holds the four buckets of 16 lanes");
  const Strides rows{d, 1};
  const cudaError_t err = pack<false>(
      y, rows, y2, n, padded_rows(n, d, kDotminBuckets), d, yp, s);
  if (err != cudaSuccess) return err;
  return sweep_any<false, false>(x, rows, yp, m, d, n, kDotminBuckets,
                                 out_d, nullptr, s);
}

}  // namespace tc

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

// the sizes a tensor-core launch takes (K6, K9 and K10 bf16, K8 on the
// tile)
bool tc_sizes_ok(int m, int n, int d, int k, int n_acc) {
  return m > 0 && n > 0 && d > 0 && d <= kMaxD && k >= 1 && k <= kLanes &&
         (n_acc == 1 || n_acc == 2 || n_acc == 4 || n_acc == 8);
}

}  // namespace

extern "C" {

// K6: x [m, d], y [n, d] row-major; round_bf16 rounds both before the dot.
// body 0: the CUDA-core body; 1: the tensor-core body (round_bf16 only),
// with the caller's scratch yp, vals, cols (see tc::fold_acc).
int avt_fold_acc(const void* x, const void* y, const void* y2, int m, int n,
                 int d, int k, int n_acc, int round_bf16, int body, void* yp,
                 void* vals, void* cols, void* out_d, void* out_i,
                 int device, void* stream) {
  if (body == 0) {
    return static_cast<int>(launch_indexed<false, true, true>(
        x, y, y2, m, n, d, k, n_acc, round_bf16, out_d, out_i, device,
        stream));
  }
  if (body != 1 || !round_bf16 || !tc_sizes_ok(m, n, d, k, n_acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tc::fold_acc<false>(
      static_cast<const float*>(x), tc::Strides{d, 1},
      static_cast<const float*>(y), tc::Strides{d, 1},
      static_cast<const float*>(y2), m, n, d, k, n_acc * kLanes,
      static_cast<uint4*>(yp), static_cast<float*>(vals),
      static_cast<int*>(cols), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<cudaStream_t>(stream)));
}

// K7: x [m, d], y [n, d] row-major, rounded; out_d [m, 128] lane minima.
// body 0: the CUDA-core body; 1: the tensor cores, with the caller's
// packed rows yp (see tc::fold_dotmin).
int avt_fold_dotmin(const void* x, const void* y, const void* y2, int m,
                    int n, int d, int body, void* yp, void* out_d,
                    int device, void* stream) {
  if (m <= 0 || n <= 0 || d <= 0 || d > kMaxD || (body != 0 && body != 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (body == 1) {
    return static_cast<int>(tc::fold_dotmin(
        static_cast<const float*>(x), static_cast<const float*>(y),
        static_cast<const float*>(y2), m, n, d, static_cast<uint4*>(yp),
        static_cast<float*>(out_d), static_cast<cudaStream_t>(stream)));
  }
  err = launch<false, true, true, false, kDotminThreads>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(y2), m, n, d, 0, 1,
      static_cast<float*>(out_d), nullptr, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// K8: x [m, d]; y2 [n]; the metric y2[col] + sum_d x[r][d]. body 0: the
// CUDA-core body; 1: the tile of the tensor-core body with an add for the
// product (tc::fold_nodot), y2p the caller's y2 padded with +inf to
// padded_rows(n, d, n_acc * 128) entries, vals and cols its scratch.
int avt_fold_nodot(const void* x, const void* y2, int m, int n, int d, int k,
                   int n_acc, int body, void* y2p, void* vals, void* cols,
                   void* out_d, void* out_i, int device, void* stream) {
  if (body == 0) {
    return static_cast<int>(launch_indexed<false, false, true>(
        x, nullptr, y2, m, n, d, k, n_acc, 0, out_d, out_i, device,
        stream));
  }
  if (body != 1 || !tc_sizes_ok(m, n, d, k, n_acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tc::fold_nodot(
      static_cast<const float*>(x), static_cast<const float*>(y2p), m, n, d,
      k, n_acc * kLanes, static_cast<float*>(vals), static_cast<int*>(cols),
      static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<cudaStream_t>(stream)));
}

// K9: xt [d, m], yt [d, n] feature-major, rounded to bf16 before the dot.
// body 0: the CUDA-core body, which takes the strides (1, m) and (1, n)
// only; 1: K6's tensor-core body (tc::fold_acc) reading xt and yt through
// the strides (x_row, x_feat) and (y_row, y_feat), with the caller's
// scratch yp, vals, cols.
int avt_fold_tpose(const void* xt, const void* yt, const void* y2, int m,
                   int n, int d, int k, int n_acc, int body, int x_row,
                   int x_feat, int y_row, int y_feat, void* yp, void* vals,
                   void* cols, void* out_d, void* out_i, int device,
                   void* stream) {
  if (body == 0) {
    if (x_row != 1 || x_feat != m || y_row != 1 || y_feat != n) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch_indexed<true, true, true>(
        xt, yt, y2, m, n, d, k, n_acc, 1, out_d, out_i, device, stream));
  }
  if (body != 1 || !tc_sizes_ok(m, n, d, k, n_acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tc::fold_acc<false>(
      static_cast<const float*>(xt), tc::Strides{x_row, x_feat},
      static_cast<const float*>(yt), tc::Strides{y_row, y_feat},
      static_cast<const float*>(y2), m, n, d, k, n_acc * kLanes,
      static_cast<uint4*>(yp), static_cast<float*>(vals),
      static_cast<int*>(cols), static_cast<float*>(out_d),
      static_cast<int*>(out_i), static_cast<cudaStream_t>(stream)));
}

// K10: the raw product of augmented operands, rounded to bf16: x [m, d] and
// y [n, d] row-major, or with tpose xt [d, m] and yt [d, n]; no y2. body 0:
// the CUDA-core body (kept to be timed against), which takes the strides
// of its layout only; 1: the tensor-core body in its raw mode
// (tc::fold_acc<true>), reading x and y through the strides (x_row, x_feat)
// and (y_row, y_feat), with the caller's scratch yp, vals, cols.
int avt_fold_raw(const void* x, const void* y, int m, int n, int d, int k,
                 int n_acc, int tpose, int body, int x_row, int x_feat,
                 int y_row, int y_feat, void* yp, void* vals, void* cols,
                 void* out_d, void* out_i, int device, void* stream) {
  if (body == 0) {
    const bool layout =
        tpose ? x_row == 1 && x_feat == m && y_row == 1 && y_feat == n
              : x_row == d && x_feat == 1 && y_row == d && y_feat == 1;
    if (!layout) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(
        tpose ? launch_indexed<true, true, false>(x, y, nullptr, m, n, d, k,
                                                  n_acc, 1, out_d, out_i,
                                                  device, stream)
              : launch_indexed<false, true, false>(x, y, nullptr, m, n, d,
                                                   k, n_acc, 1, out_d, out_i,
                                                   device, stream));
  }
  if (body != 1 || !tc_sizes_ok(m, n, d, k, n_acc)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(tc::fold_acc<true>(
      static_cast<const float*>(x), tc::Strides{x_row, x_feat},
      static_cast<const float*>(y), tc::Strides{y_row, y_feat}, nullptr, m,
      n, d, k, n_acc * kLanes, static_cast<uint4*>(yp),
      static_cast<float*>(vals), static_cast<int*>(cols),
      static_cast<float*>(out_d), static_cast<int*>(out_i),
      static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
