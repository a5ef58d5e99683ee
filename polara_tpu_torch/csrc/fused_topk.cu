// Fused factor scoring -> seen-item masking -> top-k, for NVIDIA Hopper
// (sm_90a), on the CUDA cores in f32.
//
// Replaces the Pallas TPU kernel of polara_tpu/ops/pallas.py:45-229
// (_score_topk_kernel, driven by fused_score_topk).  For every user row u
// it returns the k largest scores of proj[u] . items[c] over the columns
// c < n_valid whose seen bit is clear, in the total order (score
// descending, column ascending); slots beyond the finite scores hold PAD
// (-1) with value -inf.  Every score is the f32 chain
// acc = fmaf(proj[u][d], items[c][d], acc) for d = 0 .. rank-1 from 0, so
// the values and the picks do not depend on the tiling.
//
// What bounds it on an H100: at the main path's shape (69,878 users x
// 10,677 items, rank 50) the work is 74.6 GFLOP of f32 FMAs (no tensor
// cores, no TF32: the reference sums in f32), about 1.1 ms at the card's
// f32 peak; the bytes (proj 14 MB, panel 2.1 MB, seen bits 93 MB) take
// ~0.03 ms at HBM rate, since scores never leave the SM.  What can keep
// the FMA pipes from that peak is the shared memory that feeds them (an
// SM serves one wavefront per clock and issues four warp-FFMAs), the L2
// re-reads of the panel (once per block) and the selection's issue slots.
//
// What the design does about it:
// * A block of 8 warps owns 64 users and walks the panel in tiles of 128
//   items; every panel byte read from L2 serves 64 users (9.3 -> 2.3 GB
//   of L2 reads at the main path's shape, against 16 users before).
// * The outer product is tiled in registers: each thread holds 4 users x
//   8 items (32 accumulators).  proj (staged once) and the item tile are
//   K-major in shared memory ([d][user], [d][item]) and read as float4; a
//   warp covers 16 users x 64 items, so per rank step its 32 lanes read 4
//   proj values and 2 x 32 item values, each group contiguous: 3
//   wavefronts per 32 warp-FFMAs (6 per 8 in the previous design).
// * The K-major panel (rank x n_pad, zero past n_valid) is a scratch copy
//   written once per call by transpose_panel_kernel, so a tile is staged
//   with 16-byte cp.async copies, no index arithmetic per element.  The
//   copy of tile t+1 is issued as soon as tile t's products are done and
//   runs while tile t's scores are selected; the seen words of a tile are
//   loaded before its products, so their latency hides behind them.
// * Selection reads a 64 x 128 score tile in shared memory: each warp
//   keeps the sorted top-k lists of 8 users in registers, spread over its
//   lanes (slot s on lane s % 32), and reads each user's row in ascending
//   column order with the masks (catalog edge, packed seen bits: word
//   col / 32, bit col % 32) applied.  A candidate enters only if it beats
//   the current k-th value; candidates are inserted one at a time in
//   ascending column order (__ballot_sync picks them), so equal scores
//   never displace an entry and ties go to the lowest column.
// * That threshold test is also the TPU kernel's tile-skip guard, moved
//   into the product threads: each compares its raw scores with the k-th
//   values the selection published and flags a user only if one beats
//   it, so once the lists are warm most users' tiles cost one bit.
// * At k <= 32 the kernel fits 80 registers, so 3 blocks (24 warps) share
//   an SM and hide each other's barriers and selection.
// * Any rank: up to kMaxStagedRank (256) proj and the tile hold the whole
//   rank in shared memory (score_topk_kernel).  Above it the rank is
//   walked in slices of kSlice rows (score_topk_sliced_kernel): for each
//   slice, that slice of proj and of the K-major tile is staged and its
//   fmaf steps run, into the same accumulators, so every score is still
//   the one chain over d = 0 .. rank-1.  proj is copied K-major once per
//   call (rank x n_upad, zero past n_users), so a slice of it is staged
//   with cp.async like the tile.  The flags, the selection and the
//   prefetch (the next tile's first slice) run after the last slice.
//
// One call of polara_fused_score_topk launches two kernels, the panel
// transpose and then score_topk_kernel; above rank 256 three: the panel's
// and proj's transposes, then score_topk_sliced_kernel.
//
// Measurement variants (chip_smoke.py builds them beside the library and
// times each at the main path's inputs; the port never loads them):
//   POLARA_SYNC_STAGING         tiles copied by plain float4 loads and
//                               stores instead of cp.async
//   POLARA_PHASE_NO_SELECTION   the selection is skipped: products, score
//                               tile, flags, staging and barriers only
//   POLARA_PHASE_TRANSPOSE_ONLY the entry point returns after the
//                               transpose kernel
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUsers = 64;                     // users per block
constexpr int kTile = 128;                     // items per tile
constexpr int kUsersPerWarp = kUsers / kWarps; // in the selection
constexpr int kScoreStride = kTile + 4;        // padded score-tile row
constexpr int kMaxK = 128;
constexpr int kMaxStagedRank = 256;  // rank staged whole; above it, slices
constexpr int kSlice = 48;           // rank rows per slice (3 blocks per SM)
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

// 16-byte asynchronous copy global -> shared (bypasses L1: the panel is
// re-read by every block from L2).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// Issue the copies of one K-major item tile: rank rows of kTile values.
__device__ __forceinline__ void stage_tile(float* tile, const float* items_t,
                                           int n_pad, int base, int rank) {
  for (int e = threadIdx.x; e < rank * (kTile / 4); e += kThreads) {
    const int d = e / (kTile / 4);
    const int q = e % (kTile / 4);
    const float* src = items_t + (size_t)d * n_pad + base + 4 * q;
#ifdef POLARA_SYNC_STAGING
    *reinterpret_cast<float4*>(tile + 4 * e) =
        *reinterpret_cast<const float4*>(src);
#else
    cp_async16(tile + 4 * e, src);
#endif
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Issue the copies of one rank slice, rows d0 .. d0 + dn: of the block's
// users from the K-major proj (proj_t: rank x n_upad) and of the item tile
// at base.
__device__ __forceinline__ void stage_slice(float* uproj, float* tile,
                                            const float* proj_t, int n_upad,
                                            int user0, const float* items_t,
                                            int n_pad, int base, int d0,
                                            int dn) {
  for (int e = threadIdx.x; e < dn * (kUsers / 4); e += kThreads) {
    const int d = e / (kUsers / 4);
    const int q = e % (kUsers / 4);
    const float* src = proj_t + (size_t)(d0 + d) * n_upad + user0 + 4 * q;
#ifdef POLARA_SYNC_STAGING
    *reinterpret_cast<float4*>(uproj + 4 * e) =
        *reinterpret_cast<const float4*>(src);
#else
    cp_async16(uproj + 4 * e, src);
#endif
  }
  stage_tile(tile, items_t + (size_t)d0 * n_pad, n_pad, base, dn);
}

// The products of `steps` rank steps into a thread's 4 x 8 accumulators:
// users from pp ([d][kUsers]), items from xp ([d][kTile]).
__device__ __forceinline__ void rank_steps(float (&acc)[4][8],
                                           const float* pp, const float* xp,
                                           int steps) {
#pragma unroll 2
  for (int d = 0; d < steps; ++d) {
    const float4 p = *reinterpret_cast<const float4*>(pp + d * kUsers);
    const float4 a = *reinterpret_cast<const float4*>(xp + d * kTile);
    const float4 b =
        *reinterpret_cast<const float4*>(xp + d * kTile + kTile / 2);
    const float pv[4] = {p.x, p.y, p.z, p.w};
    const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pv[r], xv[i], acc[r][i]);
    }
  }
}

// items (n_items, rank) row-major -> items_t (rank, n_pad) row-major,
// zero in the columns at or beyond limit.  Block (32, 8), 32 x 32 tiles.
__global__ void transpose_panel_kernel(const float* __restrict__ items,
                                       float* __restrict__ items_t, int rank,
                                       int limit, int n_pad) {
  __shared__ float t[32][33];
  const int c0 = blockIdx.x * 32;
  const int d0 = blockIdx.y * 32;
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int c = c0 + r;
    const int d = d0 + threadIdx.x;
    t[r][threadIdx.x] =
        c < limit && d < rank ? items[(size_t)c * rank + d] : 0.f;
  }
  __syncthreads();
  for (int r = threadIdx.y; r < 32; r += 8) {
    const int d = d0 + r;
    if (d < rank) items_t[(size_t)d * n_pad + c0 + threadIdx.x] =
        t[threadIdx.x][r];
  }
}

// The score kernels' body.  Whole rank (SLICED false): proj is row-major
// (n_users, rank), staged once; shared memory holds rank rows.  SLICED:
// proj is the K-major copy (rank, n_upad) and shared memory holds kSlice
// rows, restaged per slice.
template <int SLOTS, bool SLICED>
__device__ __forceinline__ void score_topk_body(
    const float* __restrict__ proj, const float* __restrict__ items_t,
    int n_pad, const int* __restrict__ seen, float* __restrict__ out_vals,
    int* __restrict__ out_idx, int n_users, int rank, int n_words, int limit,
    int k, int filter_seen, int n_upad) {
  extern __shared__ float4 smem4[];
  const int staged = SLICED ? kSlice : rank;     // rank rows held
  float* uproj = reinterpret_cast<float*>(smem4);  // [staged][kUsers]
  float* tile = uproj + staged * kUsers;           // [staged][kTile]
  float* scores = tile + staged * kTile;           // [kUsers][kScoreStride]
  float* kth_s = scores + kUsers * kScoreStride;   // k-th value per user
  int* live_s = reinterpret_cast<int*>(kth_s + kUsers);  // tile may enter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int user0 = blockIdx.x * kUsers;

  if constexpr (SLICED) {
    if (limit > 0) {
      stage_slice(uproj, tile, proj, n_upad, user0, items_t, n_pad, 0, 0,
                  min(kSlice, rank));
    }
  } else {
    if (limit > 0) stage_tile(tile, items_t, n_pad, 0, rank);
  }
  if (threadIdx.x < kUsers) {
    kth_s[threadIdx.x] = -CUDART_INF_F;
    live_s[threadIdx.x] = 0;
  }
  if constexpr (!SLICED) {
    for (int e = threadIdx.x; e < kUsers * rank; e += kThreads) {
      const int u = e % kUsers;  // consecutive threads, consecutive banks
      const int d = e / kUsers;
      uproj[e] = user0 + u < n_users ? proj[(size_t)(user0 + u) * rank + d]
                                     : 0.f;
    }
  }

  // products: this thread's users 4 * ty .. +3, items 4 * tx .. +3 and
  // 64 + 4 * tx .. +3; a warp spans 4 user quads x 8 item quads
  const int ty = (warp >> 1) * 4 + (lane >> 3);
  const int tx = (warp & 1) * 8 + (lane & 7);
  const float* pp = uproj + 4 * ty;
  const float* xp = tile + 4 * tx;

  // selection: this warp's users sel0 .. sel0 + 7; lane l loads seen word
  // (base / 32 + l % 4) of user sel0 + l / 4
  const int sel0 = warp * kUsersPerWarp;
  const int word_user = user0 + sel0 + (lane >> 2);
  const int* word_row =
      seen + (size_t)(word_user < n_users ? word_user : 0) * n_words;
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

  for (int base = 0; base < limit; base += kTile) {
    unsigned word = 0;
    if (filter_seen && word_user < n_users) {
      const int w = (base >> 5) + (lane & 3);
      if (w < n_words) word = (unsigned)word_row[w];
    }
    cp_async_wait_all();
    __syncthreads();  // tile staged (and proj); last selection is done

    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    }
    if constexpr (SLICED) {
      // the accumulators carry over from slice to slice
      for (int d0 = 0;;) {
        rank_steps(acc, pp, xp, min(kSlice, rank - d0));
        d0 += kSlice;
        if (d0 >= rank) break;
        __syncthreads();  // every warp is done with this slice
        stage_slice(uproj, tile, proj, n_upad, user0, items_t, n_pad, base,
                    d0, min(kSlice, rank - d0));
        cp_async_wait_all();
        __syncthreads();
      }
    } else {
      rank_steps(acc, pp, xp, rank);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      float* row = scores + (4 * ty + r) * kScoreStride + 4 * tx;
      *reinterpret_cast<float4*>(row) =
          make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      *reinterpret_cast<float4*>(row + kTile / 2) =
          make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
    }
    // flag the users of whom some raw score beats the k-th value: masks
    // only lower scores, so an unflagged user has no candidate here
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float t = kth_s[4 * ty + r];
      bool any = false;
#pragma unroll
      for (int i = 0; i < 8; ++i) any |= acc[r][i] > t;
      if (any) live_s[4 * ty + r] = 1;
    }
    __syncthreads();  // scores written; the item tile is free
    if (base + kTile < limit) {
      if constexpr (SLICED) {
        stage_slice(uproj, tile, proj, n_upad, user0, items_t, n_pad,
                    base + kTile, 0, min(kSlice, rank));
      } else {
        stage_tile(tile, items_t, n_pad, base + kTile, rank);
      }
    }

#ifndef POLARA_PHASE_NO_SELECTION
    const unsigned live = __ballot_sync(
        kFull, lane < kUsersPerWarp && live_s[sel0 + lane] != 0);
    if (lane < kUsersPerWarp) live_s[sel0 + lane] = 0;
#pragma unroll
    for (int u = 0; u < kUsersPerWarp; ++u) {
      // warp-uniform; the row's four loads and ballots go out together
      if (!((live >> u) & 1u) || user0 + sel0 + u >= n_users) continue;
      const float* row = scores + (sel0 + u) * kScoreStride;
      float s[kTile / 32];
      unsigned cand[kTile / 32];
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const unsigned bits = __shfl_sync(kFull, word, 4 * u + i);
        s[i] = row[32 * i + lane];
        if (base + 32 * i + lane >= limit || ((bits >> lane) & 1u)) {
          s[i] = -CUDART_INF_F;
        }
        cand[i] = __ballot_sync(kFull, s[i] > kth[u]);
      }
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        while (cand[i]) {
          const int src_lane = __ffs(cand[i]) - 1;
          cand[i] &= cand[i] - 1;
          const float v = __shfl_sync(kFull, s[i], src_lane);
          if (v > kth[u]) {
            insert(top[u], v, base + 32 * i + src_lane, k, lane);
            kth[u] = kth_value(top[u], k);
          }
        }
      }
      if (lane == 0) kth_s[sel0 + u] = kth[u];
    }
#endif
  }

#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    const int user = user0 + sel0 + u;
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

// k <= 32 (the main path) fits 80 registers and runs 3 blocks per SM;
// larger k keeps its lists in registers at 2 or 1 block per SM.
template <int SLOTS>
__global__ void __launch_bounds__(kThreads,
                                  SLOTS == 1 ? 3 : SLOTS == 2 ? 2 : 1)
score_topk_kernel(const float* __restrict__ proj,
                  const float* __restrict__ items_t, int n_pad,
                  const int* __restrict__ seen, float* __restrict__ out_vals,
                  int* __restrict__ out_idx, int n_users, int rank,
                  int n_words, int limit, int k, int filter_seen) {
  score_topk_body<SLOTS, false>(proj, items_t, n_pad, seen, out_vals,
                                out_idx, n_users, rank, n_words, limit, k,
                                filter_seen, 0);
}

// rank > kMaxStagedRank: proj_t is proj K-major (rank, n_upad)
template <int SLOTS>
__global__ void __launch_bounds__(kThreads,
                                  SLOTS == 1 ? 3 : SLOTS == 2 ? 2 : 1)
score_topk_sliced_kernel(const float* __restrict__ proj_t,
                         const float* __restrict__ items_t, int n_pad,
                         const int* __restrict__ seen,
                         float* __restrict__ out_vals,
                         int* __restrict__ out_idx, int n_users, int rank,
                         int n_words, int limit, int k, int filter_seen,
                         int n_upad) {
  score_topk_body<SLOTS, true>(proj_t, items_t, n_pad, seen, out_vals,
                               out_idx, n_users, rank, n_words, limit, k,
                               filter_seen, n_upad);
}

template <int SLOTS>
int launch(const float* proj, const float* proj_t, int n_upad,
           const float* items_t, int n_pad, const int* seen, float* out_vals,
           int* out_idx, int n_users, int rank, int n_words, int limit, int k,
           int filter_seen, cudaStream_t stream) {
  const bool sliced = rank > kMaxStagedRank;
  const int staged = sliced ? kSlice : rank;
  const size_t smem = sizeof(float) * ((size_t)staged * (kUsers + kTile) +
                                       (size_t)kUsers * (kScoreStride + 2));
  cudaError_t err = sliced
      ? cudaFuncSetAttribute(score_topk_sliced_kernel<SLOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem)
      : cudaFuncSetAttribute(score_topk_kernel<SLOTS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_users + kUsers - 1) / kUsers);
  if (sliced) {
    score_topk_sliced_kernel<SLOTS><<<grid, kThreads, smem, stream>>>(
        proj_t, items_t, n_pad, seen, out_vals, out_idx, n_users, rank,
        n_words, limit, k, filter_seen, n_upad);
  } else {
    score_topk_kernel<SLOTS><<<grid, kThreads, smem, stream>>>(
        proj, items_t, n_pad, seen, out_vals, out_idx, n_users, rank,
        n_words, limit, k, filter_seen);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  proj (n_users, rank) and items
// (n_items, rank) are row-major f32; seen (n_users, n_words) holds the
// packed bits as int32; out_vals/out_idx are (n_users, k).  Columns at or
// beyond limit = min(n_valid, n_items) are masked.  items_t is scratch for
// the K-major panel: rank x n_pad f32 with n_pad = limit rounded up to a
// multiple of 128.  proj_t is scratch for the K-major proj when rank > 256
// (rank x n_upad f32, n_upad = n_users rounded up to a multiple of 64;
// unused, and may be null, at rank <= 256).  Returns a cudaError_t.
extern "C" int polara_fused_score_topk(const float* proj, const float* items,
                                       float* items_t, float* proj_t,
                                       const int* seen, float* out_vals,
                                       int* out_idx, int n_users, int n_items,
                                       int rank, int n_words, int n_valid,
                                       int k, int filter_seen, void* stream) {
  const bool sliced = rank > kMaxStagedRank;
  if (k < 1 || k > kMaxK || rank < 1 || n_users < 0 || n_items < 0 ||
      n_words < 0 || (sliced && (proj_t == nullptr ||
                                 n_users > 0x7fffffff - kUsers))) {
    return (int)cudaErrorInvalidValue;
  }
  if (n_users == 0) return (int)cudaSuccess;
  int limit = n_valid < n_items ? n_valid : n_items;
  if (limit < 0) limit = 0;
  const int n_pad = (limit + kTile - 1) / kTile * kTile;
  const int n_upad = (n_users + kUsers - 1) / kUsers * kUsers;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_pad > 0) {
    const dim3 grid(n_pad / 32, (rank + 31) / 32);
    transpose_panel_kernel<<<grid, dim3(32, 8), 0, s>>>(items, items_t, rank,
                                                        limit, n_pad);
    if (sliced) {
      const dim3 ugrid(n_upad / 32, (rank + 31) / 32);
      transpose_panel_kernel<<<ugrid, dim3(32, 8), 0, s>>>(
          proj, proj_t, rank, n_users, n_upad);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
#ifdef POLARA_PHASE_TRANSPOSE_ONLY
  return (int)cudaSuccess;
#endif
  switch ((k + 31) / 32) {
    case 1:
      return launch<1>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, n_users, rank, n_words, limit, k, filter_seen,
                       s);
    case 2:
      return launch<2>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, n_users, rank, n_words, limit, k, filter_seen,
                       s);
    case 3:
      return launch<3>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, n_users, rank, n_words, limit, k, filter_seen,
                       s);
    default:
      return launch<4>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, n_users, rank, n_words, limit, k, filter_seen,
                       s);
  }
}
