// K2 and K3: brute-force distance top-k on Hopper (sm_90a).
//
// K2 replaces the TPU kernel `_topk_kernel` (avenir_tpu/ops/pallas_distance.py
// :165, launched from `_pallas_topk_raw` at :221; public entry
// `pairwise_topk_pallas` :377). K3 replaces `_fused_topk_kernel`
// (avenir_tpu/ops/pallas_fused.py:52, launched at :102): the same kernel
// with the range normalize x = (x - mins) / span applied to the RAW test
// tile as it is loaded. Both are one template here, K3 being the
// compile-time flag kFused.
//
// What it computes: for every test row x_r, the k train rows j with the
// smallest metric y2[j] - 2 * <x_r, y_j>, ordered by (metric, j), so ties go
// to the lowest train id. |x|^2, the /n_attrs, the sqrt, the rounding and
// the sentinels are applied by the wrapper in plain torch, as the JAX
// package applies them outside its kernel (pallas_distance.py:405-420).
// Unlike the TPU kernel's lane-bucket fold (approximate, ~0.996 recall at
// k=5, pallas_distance.py:22-25), this top-k is exact.
//
// What bounds it on an H100: operations. The cross term is 2 * M * N * D
// f32 flops on the CUDA cores (no tensor cores, no TF32, no bf16: the TPU's
// bf16 cast is elided to an f32-precision dot, pallas_distance.py:70-84, and
// real bf16 fails the recall gate), at 67 TFLOP/s. Each pair adds one more
// FMA for the metric and one compare against the running k-th best. Memory
// is not the limit: x, y and y2 are read once per block from L2.
//
// Design:
// - Each block owns a tile of test rows and sweeps a contiguous range of
//   train rows in tiles staged through shared memory, d-major, with y2
//   beside them. The loop over train tiles inside the block takes the place
//   of the TPU's sequential inner grid axis. Both tiles hold all D features;
//   wider rows get fewer rows per tile, so widths up to 512 fit in 227 KB.
// - Register tiling: per step a thread forms a 4 x 8 (test x train) block of
//   dot products; per feature it reads its 4 x values with one 16-byte
//   shared load and 8 y values with two broadcast 16-byte loads, for 32
//   FMAs. Each test row then compares the smallest of its 8 metrics with its
//   k-th best, one compare per 8 candidates; only a row with a winner walks
//   them, and the insertion is a call, not 32 inlined copies.
// - Each thread keeps, per test row, an exact running top-k as a sorted list
//   and the k-th best in a register; a candidate enters only if strictly
//   below it. Within a thread train ids ascend, so a strict compare keeps
//   the lowest id on ties. The lists live in local memory (cached in L1);
//   the list capacity (8, 32 or 128) is a template argument.
// - Insertions are rare once a sweep is long, but over a short one (train
//   splits under 16,384 rows, see kLongSweep) a row keeps inserting, and a
//   warp of 128 test rows waits on some lane's insertion at most steps.
//   There each thread takes one test row instead of four, keeping the row's
//   values in registers for the whole sweep (widths up to 32).
// - When the test tiles alone cannot fill the 132 SMs, the train axis is
//   split across blocks. Each split writes its sorted (metric, id) list and a
//   second kernel merges the lists per test row by (metric, id), so the tie
//   rule holds across splits too: the result does not depend on the split.
// - fmaf chains run in feature order, with no fast-math (no
//   --use_fast_math), and K3's division is IEEE (-prec-div=true, nvcc's
//   default), so K3 on raw rows is bit-identical to K2 on rows the host
//   normalized with the same IEEE ops.
//
// Interface: plain C, bound from Python with ctypes. The caller allocates
// every buffer: out [M, k] (metric, id) and, when avt_topk_splits() > 1,
// the per-split lists part [S, M, k].

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>
#include <cstddef>

namespace {

constexpr int kRn = 8;          // train rows per register tile
constexpr int kMaxSplits = 64;  // per-split lists a merge walks
constexpr int kBlocksPerSm = 4;
constexpr size_t kDefaultSharedBytes = 48 * 1024;

struct Config {
  int rm;       // test rows per thread
  int threads;  // threads per block
  int tile_n;   // train rows per shared-memory tile
};

// A train split shorter than this keeps inserting into the top-k lists
// (about k * (1 + ln(L / k)) times per test row over L rows); a warp then
// waits on some lane's insertion at most steps, and fewer test rows per
// warp (one per thread) beat the register tiling of four.
constexpr long long kLongSweep = 16384;

size_t shared_bytes(const Config& cfg, int d) {
  const size_t tm = static_cast<size_t>(cfg.threads) * cfg.rm;
  return (static_cast<size_t>(d) * (tm + cfg.tile_n) + cfg.tile_n) *
         sizeof(float);
}

int sm_count(int device) {
  int sms = 0;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) !=
      cudaSuccess || sms <= 0) {
    sms = 132;
  }
  return sms;
}

// Train splits for a config: enough to give every SM kBlocksPerSm blocks,
// but never a split shorter than four shared-memory tiles.
long long split_count(const Config& cfg, int m, int n, int device) {
  const long long tm = static_cast<long long>(cfg.threads) * cfg.rm;
  const long long blocks_m = (m + tm - 1) / tm;
  const long long target =
      static_cast<long long>(sm_count(device)) * kBlocksPerSm;
  long long splits = (target + blocks_m - 1) / blocks_m;
  const long long most = n / (4LL * cfg.tile_n);
  if (splits > most) splits = most;
  if (splits > kMaxSplits) splits = kMaxSplits;
  if (splits < 1) splits = 1;
  return splits;
}

Config pick_config(int m, int n, int d, int device) {
  if (d > 256) return {1, 64, 32};
  if (d > 32) return {1, 128, 64};
  const Config four{4, 128, 256};
  if (n / split_count(four, m, n, device) >= kLongSweep) return four;
  return {1, 128, 256};
}

// Train rows per split of a launch with these sizes.
int split_rows(int m, int n, int d, int device) {
  const Config cfg = pick_config(m, n, d, device);
  const long long splits = split_count(cfg, m, n, device);
  return static_cast<int>((n + splits - 1) / splits);
}

// Insert (v, id) into the sorted list bd/bi of length k, dropping its last
// entry. The caller guarantees v < bd[k - 1]. Equal metrics keep their
// order, so earlier (lower) ids stay first.
__device__ __noinline__ void insert_sorted(float* bd, int* bi, int k,
                                              float v, int id) {
  int p = k - 1;
  while (p > 0 && bd[p - 1] > v) {
    bd[p] = bd[p - 1];
    bi[p] = bi[p - 1];
    --p;
  }
  bd[p] = v;
  bi[p] = id;
}

template <bool kFused, int kRm, int kCap, int kDx>
__global__ void __launch_bounds__(128)
topk_kernel(const float* __restrict__ x, const float* __restrict__ y,
            const float* __restrict__ y2, const float* __restrict__ mins,
            const float* __restrict__ span, int m, int n, int d, int k,
            int tile_n, int rows_per_split, float* __restrict__ out_d,
            int* __restrict__ out_i) {
  extern __shared__ __align__(16) float smem[];
  const int tm = blockDim.x * kRm;
  float* xs = smem;                                  // [d][tm]
  float* ys = xs + static_cast<size_t>(d) * tm;      // [d][tile_n]
  float* y2s = ys + static_cast<size_t>(d) * tile_n;  // [tile_n]
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * tm;
  const int j_begin = blockIdx.y * rows_per_split;
  const int j_end = min(n, j_begin + rows_per_split);

  // test tile, transposed to d-major; K3 normalizes the raw values here
  for (int e = tid; e < tm * d; e += blockDim.x) {
    const int r = e / d;
    const int c = e - r * d;
    const int gr = row0 + r;
    float v = 0.f;
    if (gr < m) {
      v = x[static_cast<size_t>(gr) * d + c];
      if (kFused) v = (v - mins[c]) / span[c];
    }
    xs[static_cast<size_t>(c) * tm + r] = v;
  }

  // kDx > 0: this thread's test rows stay in registers for the sweep
  float xr[kRm][kDx > 0 ? kDx : 1];
  if constexpr (kDx > 0) {
    __syncthreads();
#pragma unroll
    for (int c = 0; c < kDx; ++c) {
#pragma unroll
      for (int r = 0; r < kRm; ++r) {
        xr[r][c] = c < d ? xs[static_cast<size_t>(c) * tm + tid * kRm + r]
                         : 0.f;
      }
    }
  }

  float bd[kRm][kCap];
  int bi[kRm][kCap];
  float thr[kRm];
#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    thr[r] = CUDART_INF_F;
    for (int p = 0; p < k; ++p) {
      bd[r][p] = CUDART_INF_F;
      bi[r][p] = -1;
    }
  }

  for (int t0 = j_begin; t0 < j_end; t0 += tile_n) {
    const int tn = min(tile_n, j_end - t0);
    __syncthreads();  // the previous tile (or the x tile) is fully read
    for (int e = tid; e < tile_n * d; e += blockDim.x) {
      const int j = e / d;
      const int c = e - j * d;
      ys[static_cast<size_t>(c) * tile_n + j] =
          j < tn ? y[static_cast<size_t>(t0 + j) * d + c] : 0.f;
    }
    for (int j = tid; j < tile_n; j += blockDim.x) {
      // a padded column's metric is +inf: it never passes a threshold
      y2s[j] = j < tn ? y2[t0 + j] : CUDART_INF_F;
    }
    __syncthreads();

    for (int jj = 0; jj < tn; jj += kRn) {
      float acc[kRm][kRn];
#pragma unroll
      for (int r = 0; r < kRm; ++r) {
#pragma unroll
        for (int q = 0; q < kRn; ++q) acc[r][q] = 0.f;
      }
      if constexpr (kDx > 0) {
#pragma unroll
        for (int c = 0; c < kDx; ++c) {
          if (c >= d) break;
          const float* yrow = ys + static_cast<size_t>(c) * tile_n + jj;
          const float4 ya = *reinterpret_cast<const float4*>(yrow);
          const float4 yb = *reinterpret_cast<const float4*>(yrow + 4);
          const float yv[kRn] = {ya.x, ya.y, ya.z, ya.w,
                                 yb.x, yb.y, yb.z, yb.w};
#pragma unroll
          for (int r = 0; r < kRm; ++r) {
#pragma unroll
            for (int q = 0; q < kRn; ++q) {
              acc[r][q] = fmaf(xr[r][c], yv[q], acc[r][q]);
            }
          }
        }
      } else {
        for (int c = 0; c < d; ++c) {
          float xv[kRm];
          if constexpr (kRm == 4) {
            const float4 t = *reinterpret_cast<const float4*>(
                xs + static_cast<size_t>(c) * tm + tid * 4);
            xv[0] = t.x;
            xv[1] = t.y;
            xv[2] = t.z;
            xv[3] = t.w;
          } else {
  #pragma unroll
            for (int r = 0; r < kRm; ++r) {
              xv[r] = xs[static_cast<size_t>(c) * tm + tid * kRm + r];
            }
          }
          const float* yrow = ys + static_cast<size_t>(c) * tile_n + jj;
          const float4 ya = *reinterpret_cast<const float4*>(yrow);
          const float4 yb = *reinterpret_cast<const float4*>(yrow + 4);
          const float yv[kRn] = {ya.x, ya.y, ya.z, ya.w, yb.x, yb.y, yb.z, yb.w};
  #pragma unroll
          for (int r = 0; r < kRm; ++r) {
  #pragma unroll
            for (int q = 0; q < kRn; ++q) {
              acc[r][q] = fmaf(xv[r], yv[q], acc[r][q]);
            }
          }
        }
      }
      const float4 ya2 = *reinterpret_cast<const float4*>(y2s + jj);
      const float4 yb2 = *reinterpret_cast<const float4*>(y2s + jj + 4);
      const float y2v[kRn] = {ya2.x, ya2.y, ya2.z, ya2.w,
                              yb2.x, yb2.y, yb2.z, yb2.w};
#pragma unroll
      for (int r = 0; r < kRm; ++r) {
        float v[kRn];
        float best = CUDART_INF_F;
#pragma unroll
        for (int q = 0; q < kRn; ++q) {
          v[q] = y2v[q] - 2.f * acc[r][q];
          best = fminf(best, v[q]);
        }
        // one compare per row and chunk; the candidates, in ascending
        // train id, only when one of them beats the k-th best
        if (best < thr[r]) {
#pragma unroll
          for (int q = 0; q < kRn; ++q) {
            if (v[q] < thr[r] && jj + q < tn) {
              insert_sorted(bd[r], bi[r], k, v[q], t0 + jj + q);
              thr[r] = bd[r][k - 1];
            }
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRm; ++r) {
    const int gr = row0 + tid * kRm + r;
    if (gr < m) {
      const size_t base =
          (static_cast<size_t>(blockIdx.y) * m + gr) * static_cast<size_t>(k);
      for (int p = 0; p < k; ++p) {
        out_d[base + p] = bd[r][p];
        out_i[base + p] = bi[r][p];
      }
    }
  }
}

// Merge the per-split sorted lists of each test row by (metric, id); an
// empty slot (id -1) sorts after every real candidate.
__global__ void merge_kernel(const float* __restrict__ part_d,
                             const int* __restrict__ part_i, int m, int k,
                             int splits, float* __restrict__ out_d,
                             int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  int ptr[kMaxSplits];
  for (int s = 0; s < splits; ++s) ptr[s] = 0;
  for (int p = 0; p < k; ++p) {
    int best = -1;
    float best_v = CUDART_INF_F;
    int best_id = INT_MAX;
    for (int s = 0; s < splits; ++s) {
      if (ptr[s] >= k) continue;
      const size_t at = (static_cast<size_t>(s) * m + row) * k + ptr[s];
      const int id = part_i[at];
      if (id < 0) continue;
      const float v = part_d[at];
      if (best < 0 || v < best_v || (v == best_v && id < best_id)) {
        best = s;
        best_v = v;
        best_id = id;
      }
    }
    const size_t out = static_cast<size_t>(row) * k + p;
    if (best < 0) {
      out_d[out] = CUDART_INF_F;
      out_i[out] = -1;
    } else {
      out_d[out] = best_v;
      out_i[out] = best_id;
      ++ptr[best];
    }
  }
}

template <bool kFused, int kRm, int kCap, int kDx>
cudaError_t launch_sweep(const Config& cfg, dim3 grid, size_t smem,
                         cudaStream_t stream, const float* x, const float* y,
                         const float* y2, const float* mins, const float* span,
                         int m, int n, int d, int k, int rows_per_split,
                         float* out_d, int* out_i) {
  auto kernel = topk_kernel<kFused, kRm, kCap, kDx>;
  if (smem > kDefaultSharedBytes) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, cfg.threads, smem, stream>>>(x, y, y2, mins, span, m, n, d, k,
                                              cfg.tile_n, rows_per_split,
                                              out_d, out_i);
  return cudaGetLastError();
}

template <bool kFused, int kRm, int kDx>
cudaError_t dispatch_cap(const Config& cfg, dim3 grid, size_t smem,
                         cudaStream_t stream, const float* x, const float* y,
                         const float* y2, const float* mins, const float* span,
                         int m, int n, int d, int k, int rows_per_split,
                         float* out_d, int* out_i) {
#define AVT_SWEEP(CAP)                                                      \
  launch_sweep<kFused, kRm, CAP, kDx>(cfg, grid, smem, stream, x, y, y2,     \
                                 mins, span, m, n, d, k, rows_per_split,     \
                                 out_d, out_i)
  if (k <= 8) return AVT_SWEEP(8);
  if (k <= 32) return AVT_SWEEP(32);
  return AVT_SWEEP(128);
#undef AVT_SWEEP
}

template <bool kFused>
cudaError_t run_topk(const float* x, const float* y, const float* y2,
                     const float* mins, const float* span, int m, int n, int d,
                     int k, float* part_d, int* part_i, float* out_d,
                     int* out_i, int device, cudaStream_t stream) {
  if (m <= 0 || n <= 0 || d <= 0 || k <= 0 || k > 128 || d > 512) {
    return cudaErrorInvalidValue;
  }
  const Config cfg = pick_config(m, n, d, device);
  const int rows = split_rows(m, n, d, device);
  const int splits = (n + rows - 1) / rows;
  if (splits > 1 && (part_d == nullptr || part_i == nullptr)) {
    return cudaErrorInvalidValue;
  }
  const int tm = cfg.threads * cfg.rm;
  const dim3 grid((m + tm - 1) / tm, splits);
  const size_t smem = shared_bytes(cfg, d);
  float* sweep_d = splits > 1 ? part_d : out_d;
  int* sweep_i = splits > 1 ? part_i : out_i;
  cudaError_t err;
#define AVT_DISPATCH(RM, DX)                                                \
  dispatch_cap<kFused, RM, DX>(cfg, grid, smem, stream, x, y, y2, mins, span, \
                               m, n, d, k, rows, sweep_d, sweep_i)
  // one test row per thread keeps it in registers up to width 32; four rows
  // per thread would need 4x the registers and measured slower
  if (cfg.rm == 4) {
    err = AVT_DISPATCH(4, 0);
  } else {
    err = d <= 32 ? AVT_DISPATCH(1, 32) : AVT_DISPATCH(1, 0);
  }
#undef AVT_DISPATCH
  if (err != cudaSuccess || splits == 1) return err;
  merge_kernel<<<(m + 127) / 128, 128, 0, stream>>>(part_d, part_i, m, k,
                                                   splits, out_d, out_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Number of train splits a launch of these sizes uses: the caller allocates
// part buffers of [splits, m, k] when this is above 1.
int avt_topk_splits(int m, int n, int d, int device) {
  if (m <= 0 || n <= 0 || d <= 0) return 1;
  const int rows = split_rows(m, n, d, device);
  return (n + rows - 1) / rows;
}

// K2: x is the normalized encoded test matrix [m, d].
int avt_topk_staged(const void* x, const void* y, const void* y2, int m,
                    int n, int d, int k, void* part_d, void* part_i,
                    void* out_d, void* out_i, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_topk<false>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(y2), nullptr, nullptr, m, n, d, k,
      static_cast<float*>(part_d), static_cast<int*>(part_i),
      static_cast<float*>(out_d), static_cast<int*>(out_i), device,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

// K3: x is the RAW encoded test matrix [m, d]; mins/span [d] normalize it.
int avt_topk_fused(const void* x, const void* y, const void* y2,
                   const void* mins, const void* span, int m, int n, int d,
                   int k, void* part_d, void* part_i, void* out_d, void* out_i,
                   int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = run_topk<true>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const float*>(y2), static_cast<const float*>(mins),
      static_cast<const float*>(span), m, n, d, k, static_cast<float*>(part_d),
      static_cast<int*>(part_i), static_cast<float*>(out_d),
      static_cast<int*>(out_i), device, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err);
}

}  // extern "C"
