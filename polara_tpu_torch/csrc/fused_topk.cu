// Fused factor scoring -> seen-item masking -> top-k, for NVIDIA Hopper
// (sm_90a), on the CUDA cores in f32.
//
// Replaces the Pallas TPU kernel of polara_tpu/ops/pallas.py:45-229
// (_score_topk_kernel, driven by fused_score_topk).  For every user row u
// it returns the k largest scores of proj[u] . items[c] over the columns
// c < n_valid whose seen bit is clear, in the total order (score
// descending, column ascending); slots beyond the finite scores hold PAD
// (-1) with value -inf.  Every score is the f32 chain
// acc = fmaf(proj[u][d], items[c][d], acc) for d = 0 .. rank-1 from 0,
// computed by one block, so the values and the picks do not depend on the
// tiling, the rank slicing or the item split.
//
// What bounds it on an H100, by regime:
// * Full grids (at least blocks-per-SM x 132 blocks of 64 users: the main
//   path's 69,878 users, Netflix geometry's 480,189).  At the main path's
//   shape (x 10,677 items, rank 50) the work is 74.6 GFLOP of f32 FMAs (no
//   tensor cores, no TF32: the reference sums in f32), about 1.1 ms at the
//   card's f32 peak; the bytes (proj 14 MB, panel 2.1 MB, seen bits 93 MB)
//   take ~0.03 ms at HBM rate, since scores never leave the SM.  What keeps
//   the FMA pipes from that peak is the shared memory that feeds them (an
//   SM serves one wavefront per clock and issues four warp-FFMAs), the L2
//   re-reads of the panel (once per block) and the selection's issue slots.
// * Few users (a serving batch of 1,024 users is 16 blocks; the sweep's
//   3,494 users at rank 150, where one block fits an SM, are 55): the
//   bytes and FMAs are small and most SMs would stand idle while a few
//   blocks walk the whole catalog.  The bound there is the card's, so the
//   design spreads the items over the idle SMs (the item split below).
// * Rank above 256: proj and the tile no longer fit shared memory whole,
//   and the rank is walked in steps; the FMA work per score is 6x the
//   rank-50 path's at rank 300, so what bounds it is how fast shared
//   memory and L2 feed the FMA pipes: every step copies its rows of proj
//   and of the tile from L2, and the register tile sets how many
//   shared-memory loads each FMA costs.
//
// What the design does about it:
// * A block of 8 warps owns 64 users and walks the panel in tiles of 128
//   items; every panel byte read from L2 serves 64 users (9.3 -> 2.3 GB
//   of L2 reads at the main path's shape, against 16 users before).
// * The outer product is tiled in registers: in the whole-rank kernel each
//   thread holds 4 users x 8 items (32 accumulators).  proj and the item tile are K-major in
//   shared memory ([d][user], [d][item]) and read as float4; a warp covers
//   16 users x 64 items, so per rank step its 32 lanes read 4 proj values
//   and 2 x 32 item values, each group contiguous.
// * The K-major panel (rank x n_pad, zero past n_valid) is a scratch copy
//   written once per call by transpose_panel_kernel, so a tile is staged
//   with 16-byte cp.async copies, no index arithmetic per element.  The
//   copy of tile t+1 is issued as soon as tile t's products are done and
//   runs while tile t's scores are selected; the seen words of a tile are
//   loaded before its products, so their latency hides behind them.
// * The whole-rank kernel's selection reads a 64 x 128 score tile in
//   shared memory: each warp
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
// * At k <= 32 the whole-rank kernel fits 80 registers, so 3 blocks (24
//   warps) share an SM and hide each other's barriers and selection.
// * Item split (few users).  The grid is (user blocks, S): split s owns
//   the contiguous, ascending item tiles [s * n_tiles / S, (s + 1) *
//   n_tiles / S) and runs the same loop over them only, writing its top-k
//   to a candidate scratch (n_users, S, k).  merge_splits_kernel then
//   merges them, one warp per user: splits in ascending order, each list
//   in slot order, through the same insert().  Every entry of split s has
//   a higher column than every entry of earlier splits, and equal values
//   within a list come by ascending column, so an equal value never
//   displaces an earlier one and the merge is the stable descending sort
//   of the concatenated lists: ids and values equal S = 1's bit for bit.
//   The wrapper picks S from the occupancy the driver reports
//   (polara_fused_blocks_per_sm) and the SM count: S = 1 once the user
//   blocks fill every block slot, else the largest S whose grid still fits
//   in one wave (ops/fused_topk.py:item_splits).
// * Any rank: up to kMaxStagedRank (256) proj and the tile hold the whole
//   rank in shared memory (score_topk_kernel).  Above it,
//   score_topk_sliced_kernel walks tiles of 256 items in steps of kSlice
//   (32) rank rows over a ring of two shared-memory stages; a ring row
//   holds the block's 64 users of proj (K-major, from a copy made once
//   per call: rank x n_upad, zero past n_users) and the tile's 256 items.
//   The steps of all the block's tiles form one sequence: at the top of
//   step j the block waits for step j's copy (the only group in flight),
//   one barrier both publishes it and frees the other stage, and step
//   j+1's copy is issued into that stage before step j's FMAs, so it runs
//   under them; the last step of tile t issues tile t+1's first, whose
//   copy runs under tile t's last FMAs and its selection.  Each thread's
//   copies are fixed (two proj quads and eight item quads a step), so
//   issuing them costs a few adds.  Each thread holds 8 users x 8 items
//   (64 accumulators): 4 float4 loads feed 64 FMAs, against 3 for 32 in
//   the 4 x 8 tile, and every float copied from L2 feeds 51 FMAs (64 x
//   256 block) rather than 43 (64 x 128).  The steps accumulate into the
//   same registers, so every score is still the one chain over d = 0 ..
//   rank-1.
// * The sliced kernel selects from registers: warp w holds the whole
//   256-item rows of users 4w .. 4w + 3 and 32 + 4w .. +3 (its proj reads
//   are broadcasts), so it needs no score tile, no flags and no barrier
//   before its selection, and the 66 KB the score tile took go to the
//   ring's 32-row steps.  A row whose scores all fall below its k-th
//   value costs a max and a ballot.  A lane's scores come in 8 chunks of
//   interleaved columns (4 l + j), so the selection inserts by the total
//   order (score, then column) rather than by arrival, and a chunk with
//   kMergeMin (4) or more candidates is merged at once: a bitonic sort of
//   the chunk across the warp and a bitonic merge with the 32-slot list
//   (k <= 32), 21 exchange stages instead of 4 to 32 dependent inserts.
//   That matters most for a block's first tiles, where every score is a
//   candidate.  The lists live in shared memory (16 KB at k <= 32), read
//   and written back only for a row with a candidate, so the products
//   loop has the registers to unroll by 4 within 128 (2 blocks of 96 KB
//   shared memory per SM).
//   proj is restaged with every step rather than kept resident: a
//   resident proj (64 x rank x 4 B: 76.8 KB at rank 300) beside the item
//   ring leaves one block per SM, and chip_smoke.py's build of it
//   (POLARA_SLICED_PROJ_RESIDENT) measured slower at rank 300 (PERF.md);
//   streaming it costs a fifth of a step's bytes.
//
// One call of polara_fused_score_topk launches the panel transpose and
// then score_topk_kernel; above rank 256 also proj's transpose, and
// score_topk_sliced_kernel instead; with S > 1 then merge_splits_kernel.
//
// Measurement variants (chip_smoke.py builds them beside the library and
// times each at the main path's inputs and at rank 300; the port never
// loads them):
//   POLARA_SYNC_STAGING          tiles copied by plain float4 loads and
//                                stores instead of cp.async
//   POLARA_PHASE_NO_SELECTION    the selection is skipped: products (kept
//                                by a sum in the sliced kernel), score
//                                tile, flags, staging and barriers only
//   POLARA_PHASE_NO_COPY         the copies into shared memory are skipped
//                                (products of whatever it holds)
//   POLARA_PHASE_NO_PRODUCTS     the FMA steps are skipped (all scores 0)
//   POLARA_PHASE_TRANSPOSE_ONLY  the entry point returns after the
//                                transpose kernels
//   POLARA_SLICED_PROJ_RESIDENT  the sliced kernel stages the block's
//                                whole proj once and streams only the tile
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUsers = 64;                     // users per block
constexpr int kUsersPerWarp = kUsers / kWarps; // in the selection
constexpr int kTile = 128;         // items per tile, whole-rank kernel
constexpr int kSlicedTile = 256;   // items per tile, sliced kernel
constexpr int kMaxK = 128;
constexpr int kMaxStagedRank = 256;  // rank staged whole; above it, slices
constexpr int kSlice = 32;           // rank rows per step of the sliced ring
constexpr int kStages = 2;           // stages of the ring
constexpr int kMaxSplits = 65535;    // gridDim.y
#ifdef POLARA_SLICED_PROJ_RESIDENT
constexpr int kRingUsers = 0;        // proj resident, outside the ring
#else
constexpr int kRingUsers = kUsers;   // proj columns of a ring row
#endif
constexpr int kRingRow = kRingUsers + kSlicedTile;  // a ring row: [proj|items]
constexpr int kStageFloats = kSlice * kRingRow;     // one stage of the ring
constexpr int kPad = -1;
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ constexpr int tile_items(int rank) {
  return rank <= kMaxStagedRank ? kTile : kSlicedTile;
}

// Padded score-tile row of the whole-rank kernel.
constexpr int kScoreStride = kTile + 4;

// Floats of the sliced kernel's ring (and resident proj), where its lists
// start in shared memory.
__host__ __device__ constexpr int ring_floats(int rank) {
  return kStages * kStageFloats + (kRingUsers ? 0 : rank * kUsers);
}

// Dynamic shared memory of a block in bytes: the whole rank of proj and of
// the item tile, the score tile and the k-th values and flags; or the
// sliced ring (and a resident proj) and the block's 64 lists of 32 * slots
// entries (values and columns).
size_t score_smem(int rank, int slots) {
  return sizeof(float) *
         (rank <= kMaxStagedRank
              ? (size_t)rank * (kUsers + kTile) +
                    (size_t)kUsers * (kScoreStride + 2)
              : (size_t)ring_floats(rank) + 2 * kUsers * 32 * slots);
}

// Sorted (descending) top-k list of one user, slot s = lane + 32 * j.
template <int SLOTS>
struct TopK {
  float val[SLOTS];
  int idx[SLOTS];
};

template <int SLOTS>
__device__ __forceinline__ void init_list(TopK<SLOTS>& t) {
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    t.val[j] = -CUDART_INF_F;
    t.idx[j] = kPad;
  }
}

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

template <int SLOTS>
__device__ __forceinline__ int kth_index(const TopK<SLOTS>& t, int k) {
  const int j_last = (k - 1) >> 5;
  int c = t.idx[0];
#pragma unroll
  for (int j = 1; j < SLOTS; ++j) {
    if (j == j_last) c = t.idx[j];
  }
  return __shfl_sync(kFull, c, (k - 1) & 31);
}

// (av, ac) comes before (bv, bc) in the total order of the lists: score
// descending, column ascending.
__device__ __forceinline__ bool before(float av, int ac, float bv, int bc) {
  return av > bv || (av == bv && ac < bc);
}

// Insert (v, c): its position is the count of listed entries that come
// before it.  Unless ORDERED, c must exceed the column of every listed
// entry whose value equals v, and the count is of values >= v.
template <int SLOTS, bool ORDERED = false>
__device__ __forceinline__ void insert(TopK<SLOTS>& t, float v, int c, int k,
                                       int lane) {
  int pos = 0;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int slot = lane + 32 * j;
    const bool first = ORDERED ? before(t.val[j], t.idx[j], v, c)
                               : t.val[j] >= v;
    pos += __popc(__ballot_sync(kFull, slot < k && first));
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

// One compare-exchange stage of a bitonic network across the warp: the
// lane pair (lane, lane ^ stride) keeps the earlier entry in the lane
// whose bit `stride` equals `first_low` and the later one in the other.
__device__ __forceinline__ void exchange(float& v, int& c, int stride,
                                         bool first_low, int lane) {
  const float ov = __shfl_xor_sync(kFull, v, stride);
  const int oc = __shfl_xor_sync(kFull, c, stride);
  const bool low = (lane & stride) == 0;
  if ((low == first_low) == before(ov, oc, v, c)) {
    v = ov;
    c = oc;
  }
}

// Merge a chunk of 32 entries (one a lane; those that cannot enter are
// (-inf, PAD)) into a 32-slot list (slot = lane) at once: sort the chunk
// in the total order (a bitonic sort), pair the list's slot l with the
// chunk's entry 31 - l and keep the earlier (the first 32 of the union,
// as a bitonic sequence), then sort that (a bitonic merge).  The order
// is total, so the list is the one that inserting the entries one at a
// time leaves, whatever the network does.
__device__ __forceinline__ void merge_chunk(TopK<1>& t, float v, int c,
                                           int lane) {
#pragma unroll
  for (int size = 2; size <= 32; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      exchange(v, c, stride, (lane & size) == 0, lane);
    }
  }
  const float rv = __shfl_sync(kFull, v, 31 - lane);
  const int rc = __shfl_sync(kFull, c, 31 - lane);
  if (before(rv, rc, t.val[0], t.idx[0])) {
    t.val[0] = rv;
    t.idx[0] = rc;
  }
#pragma unroll
  for (int stride = 16; stride > 0; stride >>= 1) {
    exchange(t.val[0], t.idx[0], stride, true, lane);
  }
}

// 16-byte asynchronous copy global -> shared (bypasses L1: the panel is
// re-read by every block from L2).
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
#ifdef POLARA_PHASE_NO_COPY
  return;
#endif
#ifdef POLARA_SYNC_STAGING
  *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
#else
  cp_async16(dst, src);
#endif
}

// Issue the copies of `rows` rows of a K-major matrix (row stride
// `stride`), `width` columns from column `col`, into shared memory.
template <int width>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int stride, int col, int rows) {
  for (int e = threadIdx.x; e < rows * (width / 4); e += kThreads) {
    const int d = e / (width / 4);
    const int q = e % (width / 4);
    copy16(dst + 4 * e, src + (size_t)d * stride + col + 4 * q);
  }
}

// Issue and commit the copies of one K-major item tile of the whole-rank
// kernel: rank rows of kTile values.
__device__ __forceinline__ void stage_tile(float* tile, const float* items_t,
                                           int n_pad, int base, int rank) {
  stage_rows<kTile>(tile, items_t, n_pad, base, rank);
  cp_async_commit();
}

// Issue and commit the copies of one step of the sliced ring into the
// stage at dst: rank rows d0 .. d0 + dn (dn <= kSlice), each a ring row
// of the block's users from the K-major proj (proj_t: rank x n_upad; with
// a resident proj, staged once, not here) and of the item tile at base.
// Each thread's copies are fixed: proj rows t / 16 + 16 i, quad t % 16;
// item rows t / 64 + 4 i, quad t % 64; so a copy costs a few adds.
__device__ __forceinline__ void stage_step(float* dst, const float* proj_t,
                                           int n_upad, int user0,
                                           const float* items_t, int n_pad,
                                           int base, int d0, int dn) {
  constexpr int kProjQuads = kUsers / 4;
  constexpr int kProjRows = kThreads / kProjQuads;  // rows per pass
  constexpr int kItemQuads = kSlicedTile / 4;
  constexpr int kItemRows = kThreads / kItemQuads;
  static_assert(kSlice % kProjRows == 0 && kSlice % kItemRows == 0,
                "whole passes");
  const int t = threadIdx.x;
  if (kRingUsers != 0) {
    const int row = t / kProjQuads;
    const int q = 4 * (t % kProjQuads);
    const float* src = proj_t + (size_t)(d0 + row) * n_upad + user0 + q;
    float* to = dst + row * kRingRow + q;
#pragma unroll
    for (int i = 0; i < kSlice / kProjRows; ++i) {
      if (row + kProjRows * i < dn) {
        copy16(to + kProjRows * i * kRingRow,
               src + (size_t)kProjRows * i * n_upad);
      }
    }
  }
  const int row = t / kItemQuads;
  const int q = 4 * (t % kItemQuads);
  const float* src = items_t + (size_t)(d0 + row) * n_pad + base + q;
  float* to = dst + row * kRingRow + kRingUsers + q;
#pragma unroll
  for (int i = 0; i < kSlice / kItemRows; ++i) {
    if (row + kItemRows * i < dn) {
      copy16(to + kItemRows * i * kRingRow,
             src + (size_t)kItemRows * i * n_pad);
    }
  }
  cp_async_commit();
}

// The products of one rank step into a thread's R x 8 accumulators: R / 4
// user quads from pp (32 users apart) and two item quads from xp (`half`
// items apart).
template <int R, int half>
__device__ __forceinline__ void rank_step(float (&acc)[R][8],
                                          const float* pp, const float* xp) {
  float pv[R];
#pragma unroll
  for (int q = 0; q < R / 4; ++q) {
    const float4 p = *reinterpret_cast<const float4*>(pp + 32 * q);
    pv[4 * q] = p.x;
    pv[4 * q + 1] = p.y;
    pv[4 * q + 2] = p.z;
    pv[4 * q + 3] = p.w;
  }
  const float4 a = *reinterpret_cast<const float4*>(xp);
  const float4 b = *reinterpret_cast<const float4*>(xp + half);
  const float xv[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int r = 0; r < R; ++r) {
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[r][i] = fmaf(pv[r], xv[i], acc[r][i]);
  }
}

// `steps` rank steps: users from pp (row stride PS floats), items from xp
// (row stride XS).  The 4 x 8 tile unrolls by 2; the 8 x 8 one by 4,
// which lets the loads of later steps go out under the FMAs of earlier
// ones within the sliced kernel's 128 registers (its lists live in shared
// memory).
template <int R, int PS, int XS, int half>
__device__ __forceinline__ void rank_steps(float (&acc)[R][8],
                                           const float* pp, const float* xp,
                                           int steps) {
#ifdef POLARA_PHASE_NO_PRODUCTS
  return;
#endif
  if constexpr (R == 8) {
#pragma unroll 4
    for (int d = 0; d < steps; ++d) {
      rank_step<R, half>(acc, pp + d * PS, xp + d * XS);
    }
  } else {
#pragma unroll 2
    for (int d = 0; d < steps; ++d) {
      rank_step<R, half>(acc, pp + d * PS, xp + d * XS);
    }
  }
}

// Write a thread's 4 x 8 raw scores of the whole-rank kernel to the score
// tile (users 4 * ty .. +3, items 4 * tx .. +3 and 64 + 4 * tx .. +3) and
// flag the users of whom some raw score beats the k-th value: masks only
// lower scores, so an unflagged user has no candidate in the tile.
__device__ __forceinline__ void write_scores(const float (&acc)[4][8],
                                             float* scores,
                                             const float* kth_s, int* live_s,
                                             int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    float* row = scores + (4 * ty + r) * kScoreStride + 4 * tx;
    *reinterpret_cast<float4*>(row) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
    *reinterpret_cast<float4*>(row + kTile / 2) =
        make_float4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]);
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const float t = kth_s[4 * ty + r];
    bool any = false;
#pragma unroll
    for (int i = 0; i < 8; ++i) any |= acc[r][i] > t;
    if (any) live_s[4 * ty + r] = 1;
  }
}

// Select the whole-rank kernel's tile at base for this warp's users sel0
// .. sel0 + 7 from the score tile: each flagged user's row in ascending
// column order with the masks (catalog edge, packed seen bits: lane l
// holds word base / 32 + l % 4 of user sel0 + l / 4) applied; a candidate
// enters only if it beats the k-th value, one at a time in ascending
// column order.
template <int SLOTS>
__device__ __forceinline__ void select_tile(
    TopK<SLOTS> (&top)[kUsersPerWarp], float (&kth)[kUsersPerWarp],
    const float* scores, float* kth_s, int* live_s, unsigned word, int sel0,
    int lane, int n_live_users, int base, int limit, int k) {
#ifndef POLARA_PHASE_NO_SELECTION
  const unsigned flags =
      lane < kUsersPerWarp ? (unsigned)live_s[sel0 + lane] : 0u;
  const unsigned live = __ballot_sync(kFull, flags != 0);
  if (lane < kUsersPerWarp) live_s[sel0 + lane] = 0;
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    // warp-uniform; the row's four loads and ballots go out together
    if (!((live >> u) & 1u) || u >= n_live_users) continue;
    float kth_u = kth[u];
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
      cand[i] = __ballot_sync(kFull, s[i] > kth_u);
    }
#pragma unroll
    for (int i = 0; i < kTile / 32; ++i) {
      while (cand[i]) {
        const int src_lane = __ffs(cand[i]) - 1;
        cand[i] &= cand[i] - 1;
        const float v = __shfl_sync(kFull, s[i], src_lane);
        if (v > kth_u) {
          insert(top[u], v, base + 32 * i + src_lane, k, lane);
          kth_u = kth_value(top[u], k);
        }
      }
    }
    kth[u] = kth_u;
    if (lane == 0) kth_s[sel0 + u] = kth_u;
  }
#endif
}

// A chunk with this many candidates or more is merged at once
// (merge_chunk) rather than inserted one at a time.
constexpr int kMergeMin = 4;

// Select the sliced kernel's tile at base for the 8 users whose rows this
// warp holds in registers: row r is the block's user u(r) = first + r % 4
// + 32 (r / 4), and lane l holds its scores at columns base + 4 l + j
// (acc[r][j], j < 4) and base + 128 + 4 l + j - 4 (j >= 4).  The users'
// lists live in shared memory (list_v/list_i: 32 * SLOTS entries a user),
// so the products loop keeps their registers; a row whose scores all fall
// below its k-th value costs a max and a ballot.  Each of the 8 chunks
// acc[r][j] is masked (catalog edge, packed seen bits), and its entries
// that come before the k-th entry in the total order go in by that order:
// a later chunk may hold a lower column, so an equal score can displace
// the k-th entry, and the columns' interleaving does not change the list.
template <int SLOTS>
__device__ __forceinline__ void select_rows(
    float* list_v, int* list_i, const float (&acc)[8][8],
    const int* __restrict__ seen, int user0, int first, int n_users,
    int n_words, int base, int limit, int k, int filter_seen, int lane) {
#ifdef POLARA_PHASE_NO_SELECTION
  // keep the products: a sum of the scores the lists never see
  float sink = 0.f;
#pragma unroll
  for (int r = 0; r < kUsersPerWarp; ++r) {
#pragma unroll
    for (int j = 0; j < 8; ++j) sink += acc[r][j];
  }
  if (sink == 1.f) list_i[0] = lane;
#else
  // lane L holds seen word base / 32 + L % 8 of user first + L / 8
  // (words[0]) and of user first + 32 + L / 8 (words[1])
  unsigned words[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int user = user0 + first + 32 * h + (lane >> 3);
    const int w = (base >> 5) + (lane & 7);
    words[h] = filter_seen && user < n_users && w < n_words
                   ? (unsigned)seen[(size_t)user * n_words + w]
                   : 0u;
  }
#pragma unroll
  for (int r = 0; r < kUsersPerWarp; ++r) {
    const int u = first + (r & 3) + 32 * (r >> 2);
    if (user0 + u >= n_users) continue;
    float* lv = list_v + u * 32 * SLOTS;
    int* li = list_i + u * 32 * SLOTS;
    // masks only lower scores, and an entry needs a score >= the k-th's
    float kth = lv[k - 1];
    float row_max = acc[r][0];
#pragma unroll
    for (int i = 1; i < 8; ++i) row_max = fmaxf(row_max, acc[r][i]);
    if (!__ballot_sync(kFull, row_max >= kth)) continue;
    TopK<SLOTS> top;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      top.val[j] = lv[lane + 32 * j];
      top.idx[j] = li[lane + 32 * j];
    }
    int kth_col = kth_index(top, k);
    // lane l's columns 4 l + j and 128 + 4 l + j lie in words l / 8 and
    // 4 + l / 8 of the tile, at bit 4 (l % 8) + j
    const unsigned low_bits =
        __shfl_sync(kFull, words[r >> 2], 8 * (r & 3) + (lane >> 3));
    const unsigned high_bits =
        __shfl_sync(kFull, words[r >> 2], 8 * (r & 3) + 4 + (lane >> 3));
#pragma unroll 1
    for (int j = 0; j < 8; ++j) {
      float v = acc[r][0];
#pragma unroll
      for (int i = 1; i < 8; ++i) {
        if (j == i) v = acc[r][i];
      }
      if (!__ballot_sync(kFull, v >= kth)) continue;  // the same, a chunk
      const int col = base + 4 * lane + (j & 3) + (j < 4 ? 0 : kSlicedTile / 2);
      const unsigned bits = j < 4 ? low_bits : high_bits;
      if (col >= limit || ((bits >> (4 * (lane & 7) + (j & 3))) & 1u)) {
        v = -CUDART_INF_F;
      }
      const bool enters = before(v, col, kth, kth_col);  // PAD: v > -inf
      unsigned cand = __ballot_sync(kFull, enters);
      if constexpr (SLOTS == 1) {
        if (__popc(cand) >= kMergeMin) {  // warp-uniform
          merge_chunk(top, enters ? v : -CUDART_INF_F, enters ? col : kPad,
                      lane);
          kth = kth_value(top, k);
          kth_col = kth_index(top, k);
          continue;
        }
      }
      while (cand) {
        const int src_lane = __ffs(cand) - 1;
        cand &= cand - 1;
        const float cv = __shfl_sync(kFull, v, src_lane);
        const int cc = __shfl_sync(kFull, col, src_lane);
        if (before(cv, cc, kth, kth_col)) {
          insert<SLOTS, true>(top, cv, cc, k, lane);
          kth = kth_value(top, k);
          kth_col = kth_index(top, k);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      lv[lane + 32 * j] = top.val[j];
      li[lane + 32 * j] = top.idx[j];
    }
    __syncwarp();  // the k-th entry is read by every lane
  }
#endif
}

// Write this warp's lists (users first_user ..) to row (user * gridDim.y
// + blockIdx.y) of out_vals/out_idx: the result with one split, else the
// split's candidates.
template <int SLOTS>
__device__ __forceinline__ void write_lists(
    const TopK<SLOTS> (&top)[kUsersPerWarp], float* out_vals, int* out_idx,
    int first_user, int n_users, int k, int lane) {
#pragma unroll
  for (int u = 0; u < kUsersPerWarp; ++u) {
    const int user = first_user + u;
    if (user >= n_users) continue;
    const size_t row = ((size_t)user * gridDim.y + blockIdx.y) * k;
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int slot = lane + 32 * j;
      if (slot < k) {
        out_vals[row + slot] = top[u].val[j];
        out_idx[row + slot] = top[u].idx[j];
      }
    }
  }
}

// This block's item split: the tiles [y * n / S, (y + 1) * n / S) of the
// n tiles of `tile` items, as columns [lo, hi) clipped to limit.
__device__ __forceinline__ void split_range(int n_pad, int tile, int limit,
                                            int* lo, int* hi) {
  const int n_tiles = n_pad / tile;
  *lo = (int)((long long)blockIdx.y * n_tiles / gridDim.y) * tile;
  *hi = min(limit,
            (int)((long long)(blockIdx.y + 1) * n_tiles / gridDim.y) * tile);
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

// k <= 32 (the main path) fits 80 registers and runs 3 blocks per SM;
// larger k keeps its lists in registers at 2 or 1 block per SM.
// Whole rank (rank <= kMaxStagedRank): proj is row-major (n_users, rank)
// and staged once; the block holds rank rows of it and of the item tile.
template <int SLOTS>
__global__ void __launch_bounds__(kThreads,
                                  SLOTS == 1 ? 3 : SLOTS == 2 ? 2 : 1)
score_topk_kernel(const float* __restrict__ proj,
                  const float* __restrict__ items_t, int n_pad,
                  const int* __restrict__ seen, float* __restrict__ out_vals,
                  int* __restrict__ out_idx, int n_users, int rank,
                  int n_words, int limit, int k, int filter_seen) {
  extern __shared__ float4 smem4[];
  float* uproj = reinterpret_cast<float*>(smem4);  // [rank][kUsers]
  float* tile = uproj + rank * kUsers;             // [rank][kTile]
  float* scores = tile + rank * kTile;             // [kUsers][kScoreStride]
  float* kth_s = scores + kUsers * kScoreStride;   // k-th value per user
  int* live_s = reinterpret_cast<int*>(kth_s + kUsers);  // tile may enter
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int user0 = blockIdx.x * kUsers;
  int lo, hi;
  split_range(n_pad, kTile, limit, &lo, &hi);

  if (lo < hi) stage_tile(tile, items_t, n_pad, lo, rank);
  if (threadIdx.x < kUsers) {
    kth_s[threadIdx.x] = -CUDART_INF_F;
    live_s[threadIdx.x] = 0;
  }
  for (int e = threadIdx.x; e < kUsers * rank; e += kThreads) {
    const int u = e % kUsers;  // consecutive threads, consecutive banks
    const int d = e / kUsers;
    uproj[e] = user0 + u < n_users ? proj[(size_t)(user0 + u) * rank + d]
                                   : 0.f;
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
    init_list(top[u]);
    kth[u] = -CUDART_INF_F;
  }

  for (int base = lo; base < hi; base += kTile) {
    const int w = (base >> 5) + (lane & 3);
    const unsigned word = filter_seen && word_user < n_users && w < n_words
                              ? (unsigned)word_row[w]
                              : 0u;
    cp_async_wait_all();
    __syncthreads();  // tile staged (and proj); last selection is done

    float acc[4][8];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    }
    rank_steps<4, kUsers, kTile, kTile / 2>(acc, pp, xp, rank);
    write_scores(acc, scores, kth_s, live_s, ty, tx);
    __syncthreads();  // scores written; the item tile is free
    if (base + kTile < hi) stage_tile(tile, items_t, n_pad, base + kTile,
                                      rank);
    select_tile(top, kth, scores, kth_s, live_s, word, sel0, lane,
                n_users - user0 - sel0, base, limit, k);
  }
  write_lists(top, out_vals, out_idx, user0 + sel0, n_users, k, lane);
}

// Rank above kMaxStagedRank: proj_t is proj K-major (rank, n_upad).  The
// block walks tiles of kSlicedTile items in steps of kSlice rank rows
// over the two-stage ring; each thread holds 8 users x 8 items, and warp
// w holds the whole rows of users 4w .. 4w + 3 and 32 + 4w .. +3, which it
// selects from its registers into the block's lists in shared memory.  At
// k <= 32 it fits 128 registers and 2 blocks per SM.
template <int SLOTS>
__global__ void __launch_bounds__(kThreads, SLOTS == 1 ? 2 : 1)
score_topk_sliced_kernel(const float* __restrict__ proj_t,
                         const float* __restrict__ items_t, int n_pad,
                         const int* __restrict__ seen,
                         float* __restrict__ out_vals,
                         int* __restrict__ out_idx, int n_users, int rank,
                         int n_words, int limit, int k, int filter_seen,
                         int n_upad) {
  extern __shared__ float4 smem4[];
  float* ring = reinterpret_cast<float*>(smem4);  // [kStages][kSlice][row]
  float* resident = ring + kStages * kStageFloats;  // [rank][kUsers]
  float* list_v = ring + ring_floats(rank);         // [kUsers][32 * SLOTS]
  int* list_i = reinterpret_cast<int*>(list_v + kUsers * 32 * SLOTS);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int user0 = blockIdx.x * kUsers;
  int lo, hi;
  split_range(n_pad, kSlicedTile, limit, &lo, &hi);

  if (lo < hi) {
    if (kRingUsers == 0) {
      stage_rows<kUsers>(resident, proj_t, n_upad, user0, rank);
    }
    stage_step(ring, proj_t, n_upad, user0, items_t, n_pad, lo, 0,
               min(kSlice, rank));
  }

  for (int e = threadIdx.x; e < kUsers * 32 * SLOTS; e += kThreads) {
    list_v[e] = -CUDART_INF_F;
    list_i[e] = kPad;
  }
  __syncthreads();  // each warp reads the lists of its own users

  // products: warp w's users 4w .. 4w + 3 and 32 + 4w .. +3 (its proj
  // reads are broadcasts), lane l's items 4l .. 4l + 3 and 128 + 4l .. +3
  int stage = 0;  // the ring's stage of the current step

  for (int base = lo; base < hi; base += kSlicedTile) {
    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[r][i] = 0.f;
    }
    // the accumulators carry over from step to step
    for (int d0 = 0;;) {
      cp_async_wait_all();  // this step's copy, the only group in flight
      __syncthreads();      // ... visible to all; the other stage is free
      // the next step: this tile's next slice, or the next tile's first
      int next_base = base;
      int next_d0 = d0 + kSlice;
      if (next_d0 >= rank) {
        next_base += kSlicedTile;
        next_d0 = 0;
      }
      if (next_base < hi) {
        stage_step(ring + (stage ^ 1) * kStageFloats, proj_t, n_upad, user0,
                   items_t, n_pad, next_base, next_d0,
                   min(kSlice, rank - next_d0));
      }
      const float* step = ring + stage * kStageFloats;
      const float* pp = kRingUsers ? step : resident + d0 * kUsers;
      rank_steps<8, kRingUsers ? kRingRow : kUsers, kRingRow,
                 kSlicedTile / 2>(acc, pp + 4 * warp,
                                  step + kRingUsers + 4 * lane,
                                  min(kSlice, rank - d0));
      stage ^= 1;
      d0 += kSlice;
      if (d0 >= rank) break;
    }
    select_rows<SLOTS>(list_v, list_i, acc, seen, user0, 4 * warp, n_users,
                       n_words, base, limit, k, filter_seen, lane);
  }
#pragma unroll
  for (int r = 0; r < kUsersPerWarp; ++r) {
    const int u = 4 * warp + (r & 3) + 32 * (r >> 2);
    if (user0 + u >= n_users) continue;
    const size_t row = ((size_t)(user0 + u) * gridDim.y + blockIdx.y) * k;
    for (int slot = lane; slot < k; slot += 32) {
      out_vals[row + slot] = list_v[u * 32 * SLOTS + slot];
      out_idx[row + slot] = list_i[u * 32 * SLOTS + slot];
    }
  }
}

// Merge the item splits' lists (cand_*: n_users x splits x k, each list
// sorted as the kernels leave it) into out_* (n_users x k): one warp per
// user walks the splits in ascending order and each list in slot order,
// inserting the entries that beat the k-th value; a list descends, so its
// first entry that does not beat it ends the list.
template <int SLOTS>
__global__ void __launch_bounds__(kThreads)
merge_splits_kernel(const float* __restrict__ cand_vals,
                    const int* __restrict__ cand_idx,
                    float* __restrict__ out_vals, int* __restrict__ out_idx,
                    int n_users, int splits, int k) {
  const int lane = threadIdx.x & 31;
  const int user = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (user >= n_users) return;  // warp-uniform
  TopK<SLOTS> top;
  init_list(top);
  float kth = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) {
    const size_t row = ((size_t)user * splits + s) * k;
    bool more = true;  // warp-uniform
#pragma unroll
    for (int j = 0; j < SLOTS; ++j) {
      const int slot = lane + 32 * j;
      const bool load = more && slot < k;
      const float v = load ? cand_vals[row + slot] : -CUDART_INF_F;
      const int c = load ? cand_idx[row + slot] : kPad;
      unsigned cand = __ballot_sync(kFull, v > kth);  // PAD is -inf
      while (cand) {
        const int src_lane = __ffs(cand) - 1;
        cand &= cand - 1;
        const float cv = __shfl_sync(kFull, v, src_lane);
        const int cc = __shfl_sync(kFull, c, src_lane);
        if (!(cv > kth)) {
          more = false;
          break;
        }
        insert(top, cv, cc, k, lane);
        kth = kth_value(top, k);
      }
    }
  }
  const size_t row = (size_t)user * k;
#pragma unroll
  for (int j = 0; j < SLOTS; ++j) {
    const int slot = lane + 32 * j;
    if (slot < k) {
      out_vals[row + slot] = top.val[j];
      out_idx[row + slot] = top.idx[j];
    }
  }
}

// Let the score kernel of this rank and k class take its shared memory;
// returns its size in *smem.
template <int SLOTS>
cudaError_t configure(int rank, size_t* smem) {
  *smem = score_smem(rank, SLOTS);
  return rank > kMaxStagedRank
             ? cudaFuncSetAttribute(score_topk_sliced_kernel<SLOTS>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)*smem)
             : cudaFuncSetAttribute(score_topk_kernel<SLOTS>,
                                    cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)*smem);
}

template <int SLOTS>
int blocks_per_sm(int rank, int* blocks) {
  size_t smem = 0;
  cudaError_t err = configure<SLOTS>(rank, &smem);
  if (err != cudaSuccess) return (int)err;
  return (int)(rank > kMaxStagedRank
                   ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, score_topk_sliced_kernel<SLOTS>, kThreads,
                         smem)
                   : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                         blocks, score_topk_kernel<SLOTS>, kThreads, smem));
}

template <int SLOTS>
int launch(const float* proj, const float* proj_t, int n_upad,
           const float* items_t, int n_pad, const int* seen, float* out_vals,
           int* out_idx, float* cand_vals, int* cand_idx, int n_users,
           int rank, int n_words, int limit, int k, int filter_seen,
           int splits, cudaStream_t stream) {
  size_t smem = 0;
  cudaError_t err = configure<SLOTS>(rank, &smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n_users + kUsers - 1) / kUsers, splits);
  // one split writes the result itself; more write candidates to merge
  float* vals = splits > 1 ? cand_vals : out_vals;
  int* idx = splits > 1 ? cand_idx : out_idx;
  if (rank > kMaxStagedRank) {
    score_topk_sliced_kernel<SLOTS><<<grid, kThreads, smem, stream>>>(
        proj_t, items_t, n_pad, seen, vals, idx, n_users, rank, n_words,
        limit, k, filter_seen, n_upad);
  } else {
    score_topk_kernel<SLOTS><<<grid, kThreads, smem, stream>>>(
        proj, items_t, n_pad, seen, vals, idx, n_users, rank, n_words, limit,
        k, filter_seen);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  merge_splits_kernel<SLOTS>
      <<<(n_users + kWarps - 1) / kWarps, kThreads, 0, stream>>>(
          cand_vals, cand_idx, out_vals, out_idx, n_users, splits, k);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes.  proj (n_users, rank) and items
// (n_items, rank) are row-major f32; seen (n_users, n_words) holds the
// packed bits as int32; out_vals/out_idx are (n_users, k).  Columns at or
// beyond limit = min(n_valid, n_items) are masked.  items_t is scratch for
// the K-major panel: rank x n_pad f32 with n_pad = limit rounded up to a
// multiple of the tile, 128 items (256 at rank > 256).  proj_t is scratch for the K-major proj when rank > 256
// (rank x n_upad f32, n_upad = n_users rounded up to a multiple of 64;
// unused, and may be null, at rank <= 256).  splits is the item split S,
// 1 <= S <= max(1, n_pad / tile); with S > 1 cand_vals/cand_idx are
// scratch for the splits' lists, (n_users, S, k) f32 and int32 (unused,
// and may be null, at S = 1).  Returns a cudaError_t.
extern "C" int polara_fused_score_topk(
    const float* proj, const float* items, float* items_t, float* proj_t,
    const int* seen, float* out_vals, int* out_idx, float* cand_vals,
    int* cand_idx, int n_users, int n_items, int rank, int n_words,
    int n_valid, int k, int filter_seen, int splits, void* stream) {
  const bool sliced = rank > kMaxStagedRank;
  if (k < 1 || k > kMaxK || rank < 1 || n_users < 0 || n_items < 0 ||
      n_words < 0 || splits < 1 || splits > kMaxSplits ||
      (sliced && (proj_t == nullptr || n_users > 0x7fffffff - kUsers)) ||
      (splits > 1 && (cand_vals == nullptr || cand_idx == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  int limit = n_valid < n_items ? n_valid : n_items;
  if (limit < 0) limit = 0;
  const int tile = tile_items(rank);
  const int n_pad = (limit + tile - 1) / tile * tile;
  if (splits > 1 && splits > n_pad / tile) return (int)cudaErrorInvalidValue;
  if (n_users == 0) return (int)cudaSuccess;
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
#ifdef POLARA_SLICED_PROJ_RESIDENT
  if (sliced && score_smem(rank, (k + 31) / 32) > 232448) {
    return (int)cudaErrorInvalidValue;
  }
#endif
  switch ((k + 31) / 32) {
    case 1:
      return launch<1>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, cand_vals, cand_idx, n_users, rank, n_words,
                       limit, k, filter_seen, splits, s);
    case 2:
      return launch<2>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, cand_vals, cand_idx, n_users, rank, n_words,
                       limit, k, filter_seen, splits, s);
    case 3:
      return launch<3>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, cand_vals, cand_idx, n_users, rank, n_words,
                       limit, k, filter_seen, splits, s);
    default:
      return launch<4>(proj, proj_t, n_upad, items_t, n_pad, seen, out_vals,
                       out_idx, cand_vals, cand_idx, n_users, rank, n_words,
                       limit, k, filter_seen, splits, s);
  }
}

// Blocks of the score kernel that one SM of the current device holds at
// this rank and k (the occupancy the driver computes from the
// instantiation's registers and shared memory), in *blocks.  Returns a
// cudaError_t.
extern "C" int polara_fused_blocks_per_sm(int rank, int k, int* blocks) {
  if (k < 1 || k > kMaxK || rank < 1 || blocks == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  switch ((k + 31) / 32) {
    case 1: return blocks_per_sm<1>(rank, blocks);
    case 2: return blocks_per_sm<2>(rank, blocks);
    case 3: return blocks_per_sm<3>(rank, blocks);
    default: return blocks_per_sm<4>(rank, blocks);
  }
}
