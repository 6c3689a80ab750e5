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
// arithmetic is one compare and one add per cell. Every thread of a block
// adds into the same F * C * B cells (50 for churn), so contention on the
// atomics is the other cost.
//
// Design:
// - The TPU revisited one VMEM accumulator across a sequential grid. Blocks
//   on Hopper run in parallel and in no order, so each block keeps a private
//   histogram of the [F, C*B] combined ids in shared memory (shared-memory
//   atomics are cheap next to global ones), walks rows with a grid-stride
//   loop, and flushes once into the global array with one global atomicAdd
//   per nonzero cell.
// - Measured against redesigns at 1,048,576 churn rows (NVIDIA H100 80GB
//   HBM3, 700 W, device time of back-to-back calls, inputs in L2): this
//   body takes 0.0116 ms, its loads alone (no atomics) 0.0077, against a
//   0.0075 ms bytes bound. One histogram copy per warp took 0.0123; staging
//   the row tile with cp.async and spreading a warp's lanes over the
//   features 0.0133; with a __match_any_sync vote that merges the lanes of
//   one cell on top, 0.0337. The atomics cost this body a third of its
//   time, none of the three takes it back, so the body stays. With its
//   inputs read from HBM it takes 0.0195 ms, 38% of that bound.
// - Where F * C * B cells do not fit the 227 KB a block may hold, a second
//   variant adds straight into the global array with global atomics.
// - Unweighted counts accumulate in int32: integer adds are exact in any
//   order, so the result is bit-identical run to run whatever the order of
//   the atomics. The wrapper casts once to f32.
// - Weighted counts accumulate f32 with float atomics; 0/1 masks stay exact,
//   other weights carry the usual f32 summation-order caveat
//   (pallas_histogram.py:17-19).
// - Integer sums (`avt_cfb_sums_int`, the boosting channels): the weights
//   are integer-valued f32 (fixed-point gradient and hessian quanta), each
//   cast once to int32 and added in int32, in shared memory and in the
//   output, so the sums are exact and the same in any atomic order. The
//   caller keeps every cell below 2^31: N * max|w| < 2^31 for one launch.
//
// Interface: plain C, bound from Python with ctypes. The caller allocates
// `out` (int32 unweighted or f32 weighted); these functions zero it on
// `stream`, launch, and return the cudaError_t of the launch.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <mutex>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
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

// K4: pair contingency counts, every pair of a job in one launch.
//
// Replaces the TPU kernel `_pair_kernel` (avenir_tpu/ops/pallas_histogram.py
// :133, launched from `pair_counts` at :178), which counts one pair (a, b)
// over rows n:
//
//     out[a(n)][b(n)] += weight(n)      (1 when unweighted)
//
// Rows whose a id lies outside [0, n_a) or whose b id lies outside [0, n_b)
// drop out, as the compare-against-iota one-hots of the TPU kernel drop
// them. Here, for P pairs (c_a[p], c_b[p]) of the columns of an id matrix
// ids [K, N] (column k contiguous at ids + k * ld), one launch computes every
// pair's counts:
//
//     out_p[ids[c_a[p]][n]][ids[c_b[p]][n]] += weight(n)
//
// One pair is the case P = 1 (the wrapper's `pair_counts`, whose two
// columns may lie anywhere: ld is the distance from the first to the
// second).
//
// What bounds it: bytes, each distinct column its pairs name read once
// (N * 4 bytes each, plus N * 4 for weights), and the counts written once.
// A kernel for one pair, launched per pair, made the MI job's F * F = 100
// launches of ~2.6 us of device time each behind 50-100 us of host work,
// and read each column F times. With one pair this body matches that
// kernel, which streamed its two columns with plain loads, and so replaces
// it: at 16,777,216 rows it took 0.0597-0.0599 ms a call against that
// kernel's 0.0599-0.0601 (chained, the two side by side on an NVIDIA H100
// 80GB HBM3 at 700 W).
//
// Design:
// - A block owns a range of rows. For each tile of rows it stages every
//   column its pairs name into shared memory with 16-byte cp.async copies
//   (4-byte ones where a column is not 16-byte aligned), double-buffered, so
//   each column is read from device memory once; then it walks the tile's
//   (row, pair) items from shared memory.
// - The pairs' histograms sit side by side in shared memory. The wrapper
//   plans groups of pairs whose cells, staged columns and pair table fit
//   227 KB (the MI job: one group, 100 pairs x 162 cells x 4 B = 64.8 KB);
//   the grid's second dimension runs the groups. A pair too large for
//   shared memory alone forms a group that adds into the global result
//   directly. A group of fewer than 32 pairs keeps one copy of its
//   histograms per warp where they fit.
// - Pairs are taken 32 at a time: lane -> (pair, row offset), with the
//   pair's columns, cardinalities and cell offset in registers for the
//   whole tile. With 32 or more pairs the 32 lanes of an atomic hit 32
//   different pairs, whose cells are disjoint; with q < 32 pairs a warp
//   covers 32 / q rows a step. Each thread loads four rows' ids before it
//   adds, so that the loads overlap.
// - A group's tile holds about 8,192 / pairs rows, 256 to 2,048 (the
//   wrapper's planner chooses them), so that a few pairs still give each
//   thread several items between two barriers.
// - The flush is the trap: at the MI shape a block's histograms hold 16,200
//   cells, and every block flushes them with one global atomic per nonzero
//   cell onto the same addresses. The grid is sized by the work: a block
//   takes at least kFlushRatio rows per cell of a pair, and no more blocks
//   than the card holds at once. (At the MI shape on an H100, ratios 1 and 2
//   took 0.0275 and 0.0273 ms, 4 took 0.0336: more blocks help more than
//   the flush costs.)
// - Unweighted counts accumulate in int32, exact in any atomic order; the
//   wrapper casts once to f32. Weighted counts accumulate f32.

// rows a block takes per cell of one pair, so that its increments outnumber
// its flush kFlushRatio to one
constexpr int kFlushRatio = 2;
// a group's staged tile: at least kMinPairTileRows rows, each column padded
// by kPairTilePad words (16-byte alignment kept, and the same row of two
// columns on different banks)
constexpr int kMinPairTileRows = 256;
constexpr int kPairTilePad = 4;

__host__ __device__ constexpr int round_up4(int x) { return (x + 3) & ~3; }

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Queue copies of `runs` runs of `count` words each, run s from src(s) to
// dst + s * dst_stride (shared), with the block's threads: 16-byte copies
// where every run starts 16-byte aligned on both sides (`vec`), 4-byte ones
// for the rest and for a tail that is not a whole 16 bytes.
template <typename Src>
__device__ __forceinline__ void stage_runs(int* dst, int dst_stride, Src src,
                                           int runs, int count, bool vec) {
  int done = 0;
  if (vec) {
    const int quads = count >> 2;
    for (int i = threadIdx.x; i < runs * quads; i += kThreads) {
      const int s = i / quads;
      const int q = i - s * quads;
      cp_async16(dst + s * dst_stride + 4 * q, src(s) + 4 * q);
    }
    done = quads << 2;
  }
  const int rest = count - done;
  for (int i = threadIdx.x; i < runs * rest; i += kThreads) {
    const int s = i / rest;
    const int k = done + i - s * rest;
    cp_async4(dst + s * dst_stride + k, src(s) + k);
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Row blocks for a launch of `kernel` over n rows: no more than the card
// holds at once (per group of the second grid dimension), at least
// `min_rows` rows a block where the flush asks for it, at least one tile a
// block. Returns the rows a block takes (a multiple of 4, so that every
// block's first row keeps 16-byte alignment) and sets `blocks`.
template <typename Kernel>
cudaError_t plan_rows(Kernel kernel, size_t smem, int device, int n,
                      int tile_rows, long long min_rows, int groups,
                      int* blocks, int* rows_per_block) {
  // the occupancy of each (kernel, shared memory) asked once: the query
  // costs host time on every call, and a call captured into a CUDA graph
  // then makes none
  struct Seen {
    const void* kernel;
    size_t smem;
    int per_sm;
  };
  static Seen seen[64];
  static int n_seen = 0;
  static std::mutex lock;
  int per_sm = 0;
  {
    std::lock_guard<std::mutex> hold(lock);
    const void* key = reinterpret_cast<const void*>(kernel);
    for (int i = 0; i < n_seen && per_sm == 0; ++i) {
      if (seen[i].kernel == key && seen[i].smem == smem) {
        per_sm = seen[i].per_sm;
      }
    }
    if (per_sm == 0) {
      cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, kernel, kThreads, smem);
      if (err != cudaSuccess) return err;
      if (per_sm < 1) per_sm = 1;
      if (n_seen < 64) seen[n_seen++] = {key, smem, per_sm};
    }
  }
  long long want = (static_cast<long long>(n) + tile_rows - 1) / tile_rows;
  const long long resident = static_cast<long long>(per_sm) *
                             sm_count(device) / (groups > 0 ? groups : 1);
  if (want > resident) want = resident;
  if (min_rows > 0 && want > n / min_rows) want = n / min_rows;
  if (want < 1) want = 1;
  const long long rows = round_up4(
      static_cast<int>((static_cast<long long>(n) + want - 1) / want));
  *rows_per_block = static_cast<int>(rows);
  *blocks = static_cast<int>((n + rows - 1) / rows);
  return cudaSuccess;
}

// A group of pairs, as the wrapper's plan stores it (two int4 a group):
// its pairs [pair_begin, pair_end) and columns [slot_begin, slot_end) in
// the plan's lists, the cells of its histograms, the copies of them it
// keeps in shared memory (0: it adds into `out` directly), where its cells
// start in `out`, and the rows of its staged tiles.
struct PairGroup {
  int pair_begin, pair_end, slot_begin, slot_end;
  int cells, copies, out_off, tile_rows;
};

// A pair (one int4): x = slot_a | slot_b << 16 (its columns' places in its
// group's staged tile), y = n_a, z = n_b, w = where its cells start in the
// group's histogram.
//
// The plan: n_groups PairGroups, then n_pairs int4 pairs, then the column
// (slot) lists of the groups, each entry a column of `ids`.
//
// Shared memory: [the group's pairs][copies * cells histogram words, to 16
// bytes][two tiles of (slots + weighted) * (tile_rows + kPairTilePad)
// words]; the weights are the tile's last column.
template <typename Acc, bool kWeighted>
__global__ void __launch_bounds__(kThreads)
pair_counts_multi_kernel(const int* __restrict__ ids, long long ld,
                         const float* __restrict__ weights, int n,
                         int rows_per_block, const int* __restrict__ plan,
                         int n_groups, int n_pairs, bool vec,
                         Acc* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const PairGroup g = reinterpret_cast<const PairGroup*>(plan)[blockIdx.y];
  const int n_p = g.pair_end - g.pair_begin;
  const int n_slots = g.slot_end - g.slot_begin;
  const int runs = n_slots + (kWeighted ? 1 : 0);
  const long long row_begin = static_cast<long long>(blockIdx.x) *
                              rows_per_block;
  if (row_begin >= n) return;
  const int rows = static_cast<int>(
      n - row_begin < rows_per_block ? n - row_begin : rows_per_block);
  const int tile_rows = g.tile_rows;
  const int stride = tile_rows + kPairTilePad;
  const int n_tiles = (rows + tile_rows - 1) / tile_rows;
  const int tid = threadIdx.x;

  int4* meta = reinterpret_cast<int4*>(smem_raw);
  const int meta_words = 4 * n_p;
  const int4* pairs = reinterpret_cast<const int4*>(plan + 8 * n_groups) +
                      g.pair_begin;
  for (int i = tid; i < n_p; i += kThreads) meta[i] = pairs[i];
  const int* slots = plan + 8 * n_groups + 4 * n_pairs + g.slot_begin;
  Acc* hist_base = reinterpret_cast<Acc*>(smem_raw) + meta_words;
  Acc* hist = out + g.out_off;
  if (g.copies > 0) {
    for (int i = tid; i < g.copies * g.cells; i += kThreads) {
      hist_base[i] = Acc(0);
    }
    hist = hist_base + ((tid / 32) % g.copies) * g.cells;
  }
  int* tiles = reinterpret_cast<int*>(smem_raw) + meta_words +
               (g.copies > 0 ? round_up4(g.copies * g.cells) : 0);
  const int tile_words = runs * stride;

  auto column = [&](int s) -> const int* {
    if (kWeighted && s == n_slots) {
      return reinterpret_cast<const int*>(weights) + row_begin;
    }
    return ids + static_cast<long long>(__ldg(slots + s)) * ld + row_begin;
  };
  auto stage = [&](int t) {
    const int r0 = t * tile_rows;
    const int count = rows - r0 < tile_rows ? rows - r0 : tile_rows;
    stage_runs(tiles + (t & 1) * tile_words, stride,
               [&](int s) { return column(s) + r0; }, runs, count, vec);
    cp_async_commit();
  };

  stage(0);
  const int warp = tid / 32;
  const int lane = tid & 31;
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      stage(t + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int* tile = tiles + (t & 1) * tile_words;
    const int r0 = t * tile_rows;
    const int count = rows - r0 < tile_rows ? rows - r0 : tile_rows;
    // pairs in chunks of up to 32: lane -> (pair, row offset)
    for (int p0 = 0; p0 < n_p; p0 += 32) {
      const int q = n_p - p0 < 32 ? n_p - p0 : 32;
      const int per = 32 / q;
      if (lane >= q * per) continue;
      const int4 m = meta[p0 + lane % q];
      const int* col_a = tile + (m.x & 0xffff) * stride;
      const int* col_b = tile + (m.x >> 16) * stride;
      const int* col_w = tile + n_slots * stride;
      Acc* h = hist + m.w;
      const int step = kWarps * per;
      auto add = [&](int ia, int ib, int r) {
        if (static_cast<unsigned>(ia) < static_cast<unsigned>(m.y) &&
            static_cast<unsigned>(ib) < static_cast<unsigned>(m.z)) {
          if constexpr (kWeighted) {
            atomicAdd(&h[ia * m.z + ib], __int_as_float(col_w[r]));
          } else {
            atomicAdd(&h[ia * m.z + ib], Acc(1));
          }
        }
      };
      int r = warp * per + lane / q;
      for (; r + 3 * step < count; r += 4 * step) {
        int ia[4];
        int ib[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          ia[u] = col_a[r + u * step];
          ib[u] = col_b[r + u * step];
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) add(ia[u], ib[u], r + u * step);
      }
      for (; r < count; r += step) add(col_a[r], col_b[r], r);
    }
    __syncthreads();  // this buffer is restaged two tiles on
  }
  if (g.copies > 0) {
    for (int i = tid; i < g.cells; i += kThreads) {
      Acc v = Acc(0);
      for (int k = 0; k < g.copies; ++k) v += hist_base[k * g.cells + i];
      if (v != Acc(0)) atomicAdd(&out[g.out_off + i], v);
    }
  }
}

template <typename Acc, bool kWeighted>
cudaError_t launch_pair_multi(const int* ids, long long ld,
                              const float* weights, int n, const int* plan,
                              int n_groups, int n_pairs, int total_cells,
                              int smem_bytes, int cells_per_pair, Acc* out,
                              int device, cudaStream_t stream) {
  cudaError_t err = cudaMemsetAsync(out, 0, total_cells * sizeof(Acc),
                                    stream);
  if (err != cudaSuccess) return err;
  auto kernel = pair_counts_multi_kernel<Acc, kWeighted>;
  const size_t smem = static_cast<size_t>(smem_bytes);
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem_bytes);
    if (err != cudaSuccess) return err;
  }
  int blocks = 0;
  int rows_per_block = 0;
  err = plan_rows(kernel, smem, device, n, kMinPairTileRows,
                  static_cast<long long>(kFlushRatio) * cells_per_pair,
                  n_groups, &blocks, &rows_per_block);
  if (err != cudaSuccess) return err;
  const bool vec = aligned16(ids) && ld % 4 == 0 &&
                   (!kWeighted || aligned16(weights));
  kernel<<<dim3(blocks, n_groups), kThreads, smem, stream>>>(
      ids, ld, weights, n, rows_per_block, plan, n_groups, n_pairs, vec, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K4, every pair of a job: ids [K, ld] int32 (column k at ids + k * ld, n
// rows each), weights [n] f32 or null, `plan` the wrapper's device plan of
// n_groups groups and n_pairs pairs (see PairGroup), `smem_bytes` the
// largest group's shared memory, `cells_per_pair` the most cells a pair of
// a shared-memory group holds on average; out [total_cells], int32
// unweighted or f32 weighted, zeroed here on `stream`.
int avt_pair_counts_multi(const void* ids, long long ld, const void* weights,
                          int n, const void* plan, int n_groups, int n_pairs,
                          int total_cells, int smem_bytes, int cells_per_pair,
                          void* out, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto s = static_cast<cudaStream_t>(stream);
  const int* p = static_cast<const int*>(plan);
  if (weights != nullptr) {
    err = launch_pair_multi<float, true>(
        static_cast<const int*>(ids), ld, static_cast<const float*>(weights),
        n, p, n_groups, n_pairs, total_cells, smem_bytes, cells_per_pair,
        static_cast<float*>(out), device, s);
  } else {
    err = launch_pair_multi<int, false>(
        static_cast<const int*>(ids), ld, nullptr, n, p, n_groups, n_pairs,
        total_cells, smem_bytes, cells_per_pair, static_cast<int*>(out),
        device, s);
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

// K1's integer mode: weights [n] integer-valued f32, out [f, c * b] int32
// exact sums, zeroed here on `stream`.
int avt_cfb_sums_int(const void* bins, const void* labels, const void* weights,
                     int n, int f, int c, int b, void* out, int device,
                     void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch<int, true>(static_cast<const int*>(bins),
                          static_cast<const int*>(labels),
                          static_cast<const float*>(weights), n, f, c, b,
                          static_cast<int*>(out), device,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

const char* avt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
