// Fused factor scoring -> seen-item masking -> top-k, for NVIDIA Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel polara_tpu/ops/pallas.py:_score_topk_kernel
// (driven by fused_score_topk).  For every user row u it returns the k
// largest scores of proj[u] . items[c] over the columns c < n_valid whose
// seen bit is clear, in the total order (score descending, column
// ascending); slots beyond the finite scores hold PAD (-1) with value -inf.
//
// What bounds it on an H100: for the main path (69,878 users x 10,677
// items, rank 50) the work is 37 G f32 FMAs and the inputs are small
// (proj 14 MB, panel 2.1 MB, seen bits 93 MB).  Scores never leave the SM,
// so HBM traffic is a few hundred MB.  The limits are the f32 FMA rate (no
// tensor cores, no TF32: the reference accumulates in f32), the
// shared-memory bandwidth that feeds the FMAs, and the L2 re-reads of the
// item panel, which every block streams once.
//
// What the design does about it:
// * A block of 8 warps owns 16 users (2 per warp) and streams the panel
//   through shared memory in tiles of 128 items; each staged item value
//   feeds the FMAs of both users of a warp, and every panel byte read from
//   L2 serves 16 users.
// * Tile rows are stored with an odd stride, so the 32 lanes of a warp,
//   each reading its own item row at the same rank offset, hit 32
//   different banks.
// * Masks (catalog edge, packed seen bits: word col/32, bit col%32) are
//   applied in registers.
// * Each warp keeps the sorted top-k list of each of its users in
//   registers, spread over its lanes (slot s on lane s%32).  A candidate
//   enters only if it beats the current k-th value; candidates are
//   inserted one at a time in ascending column order (__ballot_sync picks
//   them), so equal scores never displace an entry and ties go to the
//   lowest column.  That threshold test is also the TPU kernel's tile-skip
//   guard: once a list is warm, a tile whose scores cannot enter costs one
//   ballot per item group.
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kUsersPerWarp = 2;
constexpr int kUsersPerBlock = kWarps * kUsersPerWarp;
constexpr int kItemsPerLane = 4;
constexpr int kTile = 32 * kItemsPerLane;
constexpr int kMaxK = 128;
constexpr int kMaxRank = 256;
constexpr int kPad = -1;
constexpr unsigned kFull = 0xffffffffu;

// Sorted (descending) top-k list of one user, slot s = lane + 32 * j.
template <int SLOTS>
struct TopK {
  float val[SLOTS];
  int idx[SLOTS];
};

template <int SLOTS>
__device__ __forceinline__ float kth_value(const TopK<SLOTS>& t, int k) {
  const int j_last = (k - 1) >> 5;
  float v = t.val[0];
#pragma unroll
  for (int j = 1; j < SLOTS; ++j) {
    if (j == j_last) v = t.val[j];
  }
  return __shfl_sync(kFull, v, (k - 1) & 31);
}

// Insert (v, c) where c exceeds every column already in the list: its
// position is the count of entries with a value >= v.
template <int SLOTS>
__device__ __forceinline__ void insert(TopK<SLOTS>& t, float v, int c, int k,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int slot = lane + 32 * j;
    pos += __popc(__ballot_sync(kFull, slot < k && t.val[j] >= v));
  }
  float prev_val[SLOTS];
  int prev_idx[SLOTS];
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const float up_v = __shfl_up_sync(kFull, t.val[j], 1);
    const int up_i = __shfl_up_sync(kFull, t.idx[j], 1);
    const float wrap_v = __shfl_sync(kFull, j > 0 ? t.val[j - 1] : 0.f, 31);
    const int wrap_i = __shfl_sync(kFull, j > 0 ? t.idx[j - 1] : 0, 31);
    prev_val[j] = lane == 0 ? wrap_v : up_v;
    prev_idx[j] = lane == 0 ? wrap_i : up_i;
  }
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int slot = lane + 32 * j;
    if (slot == pos) {
      t.val[j] = v;
      t.idx[j] = c;
    } else if (slot > pos) {
      t.val[j] = prev_val[j];
      t.idx[j] = prev_idx[j];
    }
  }
}

template <int SLOTS>
__global__ void __launch_bounds__(kWarps * 32)
score_topk_kernel(const float* __restrict__ proj,
                  const float* __restrict__ items,
                  const int* __restrict__ seen, float* __restrict__ out_vals,
                  int* __restrict__ out_idx, int n_users, int rank,
                  int n_words, int limit, int k, int filter_seen) {
  extern __shared__ float smem[];
  const int stride = rank | 1;
  float* tile = smem;                          // kTile rows of `stride`
  float* uproj = smem + kTile * stride;        // kUsersPerBlock x rank
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int user0 = blockIdx.x * kUsersPerBlock;

  for (int e = threadIdx.x; e < kUsersPerBlock * rank; e += blockDim.x) {
    const int u = user0 + e / rank;
    uproj[e] = u < n_users ? proj[(size_t)user0 * rank + e] : 0.f;
  }

  TopK<SLOTS> top[kUsersPerWarp];
  float kth[kUsersPerWarp];
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      top[u].val[j] = -CUDART_INF_F;
      top[u].idx[j] = kPad;
    }
    kth[u] = -CUDART_INF_F;
  }
  const float* wproj = uproj + warp * kUsersPerWarp * rank;

  for (int base = 0; base < limit; base += kTile) {
    __syncthreads();  // the previous tile is consumed (and proj staged)
    const int n_here = min(kTile, limit - base);
    const float* src = items + (size_t)base * rank;
    for (int e = threadIdx.x; e < n_here * rank; e += blockDim.x) {
      const int it = e / rank;
      tile[it * stride + (e - it * rank)] = src[e];
    }
    __syncthreads();

    float acc[kUsersPerWarp][kItemsPerLane];
#pragma unroll
    for (int u = 0; u < kUsersPerWarp; ++u) {
#pragma unroll
      for (int i = 0; i < kItemsPerLane; ++i) acc[u][i] = 0.f;
    }
    for (int d = 0; d < rank; ++d) {
      float x[kItemsPerLane];
#pragma unroll
      for (int i = 0; i < kItemsPerLane; ++i) {
        x[i] = tile[(lane + 32 * i) * stride + d];
      }
#pragma unroll
      for (int u = 0; u < kUsersPerWarp; ++u) {
        const float p = wproj[u * rank + d];
#pragma unroll
        for (int i = 0; i < kItemsPerLane; ++i) {
          acc[u][i] = fmaf(p, x[i], acc[u][i]);
        }
      }
    }

#pragma unroll
    for (int u = 0; u < kUsersPerWarp; ++u) {
      const int user = user0 + warp * kUsersPerWarp + u;
      if (user >= n_users) continue;  // warp-uniform
      unsigned word = 0;
      if (filter_seen && lane < kItemsPerLane) {
        const int w = (base >> 5) + lane;
        if (w < n_words) word = (unsigned)seen[(size_t)user * n_words + w];
      }
#pragma unroll
      for (int i = 0; i < kItemsPerLane; ++i) {
        const unsigned bits = __shfl_sync(kFull, word, i);
        const int col = base + 32 * i + lane;
        float s = acc[u][i];
        if (col >= limit || ((bits >> lane) & 1u)) s = -CUDART_INF_F;
        unsigned cand = __ballot_sync(kFull, s > kth[u]);
        while (cand) {
          const int src_lane = __ffs(cand) - 1;
          cand &= cand - 1;
          const float v = __shfl_sync(kFull, s, src_lane);
          if (v > kth[u]) {
            insert(top[u], v, base + 32 * i + src_lane, k, lane);
            kth[u] = kth_value(top[u], k);
          }
        }
      }
    }
  }

#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    const int user = user0 + warp * kUsersPerWarp + u;
    if (user >= n_users) continue;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int slot = lane + 32 * j;
      if (slot < k) {
        out_vals[(size_t)user * k + slot] = top[u].val[j];
        out_idx[(size_t)user * k + slot] = top[u].idx[j];
      }
    }
  }
}

template <int SLOTS>
int launch(const float* proj, const float* items, const int* seen,
           float* out_vals, int* out_idx, int n_users, int rank, int n_words,
           int limit, int k, int filter_seen, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)kTile * (rank | 1) +
                                       (size_t)kUsersPerBlock * rank);
  cudaError_t err = cudaFuncSetAttribute(
      score_topk_kernel<SLOTS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_users + kUsersPerBlock - 1) / kUsersPerBlock);
  score_topk_kernel<SLOTS><<<grid, kWarps * 32, smem, stream>>>(
      proj, items, seen, out_vals, out_idx, n_users, rank, n_words, limit, k,
      filter_seen);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  proj (n_users, rank) and items
// (n_items, rank) are row-major f32; seen (n_users, n_words) holds the
// packed bits as int32; out_vals/out_idx are (n_users, k).  Columns at or
// beyond min(n_valid, n_items) are masked.  Returns a cudaError_t.
extern "C" int polara_fused_score_topk(const float* proj, const float* items,
                                       const int* seen, float* out_vals,
                                       int* out_idx, int n_users, int n_items,
                                       int rank, int n_words, int n_valid,
                                       int k, int filter_seen, void* stream) {
  if (k < 1 || k > kMaxK || rank < 1 || rank > kMaxRank || n_users < 0 ||
      n_items < 0 || n_words < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_users == 0) return (int)cudaSuccess;
  const int limit = n_valid < n_items ? n_valid : n_items;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((k + 31) / 32) {
    case 1:
      return launch<1>(proj, items, seen, out_vals, out_idx, n_users, rank,
                       n_words, limit, k, filter_seen, s);
    case 2:
      return launch<2>(proj, items, seen, out_vals, out_idx, n_users, rank,
                       n_words, limit, k, filter_seen, s);
    case 3:
      return launch<3>(proj, items, seen, out_vals, out_idx, n_users, rank,
                       n_words, limit, k, filter_seen, s);
    default:
      return launch<4>(proj, items, seen, out_vals, out_idx, n_users, rank,
                       n_words, limit, k, filter_seen, s);
  }
}
