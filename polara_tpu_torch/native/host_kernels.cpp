// Host-side native kernels of polara_tpu_torch: the port's own copy of
// polara_tpu/native/host_kernels.cpp, with the same C interface.
//
// The reference's "native" tier is Numba-JIT CPU kernels
// (polara/lib/sampler.py:11-165, sparse.py:92-169).  Device compute runs
// in PyTorch; the work that stays on the host — ingestion bookkeeping,
// holdout selection and per-row exclusion sampling over huge catalogs —
// lives here as a small C++ library loaded through ctypes
// (polara_tpu_torch/native/__init__.py), with numpy fallbacks when no
// toolchain is available.
//
// Build (done at first use, into polara_tpu_torch/_build/):
//   g++ -O3 -std=c++17 -fopenmp -shared -fPIC host_kernels.cpp -o lib.so

#include <algorithm>
#include <cstdint>
#include <numeric>
#include <random>
#include <unordered_map>
#include <unordered_set>
#include <vector>

#ifdef _OPENMP
#include <omp.h>
#endif

extern "C" {

// CSR row-pointer from row-sorted COO rows.
void build_indptr(const int32_t* rows, int64_t nnz, int32_t n_rows,
                  int64_t* indptr) {
    std::fill(indptr, indptr + n_rows + 1, int64_t{0});
    for (int64_t e = 0; e < nnz; ++e) {
        ++indptr[rows[e] + 1];
    }
    for (int32_t i = 0; i < n_rows; ++i) {
        indptr[i + 1] += indptr[i];
    }
}

// Per-row uniform sampling without replacement from [0, n_cols) excluding
// each row's seen set (CSR layout).  Rejection sampling against a hash set
// — optimal when seen sets are sparse relative to the catalog (the
// recommender regime); OpenMP over rows.  Deterministic per (seed, row).
int sample_unseen_rows(const int64_t* indptr, const int32_t* indices,
                       int32_t n_rows, int32_t n_cols, int32_t k,
                       uint64_t seed, int32_t* out) {
    int status = 0;
#ifdef _OPENMP
#pragma omp parallel for schedule(dynamic, 64)
#endif
    for (int32_t r = 0; r < n_rows; ++r) {
        const int64_t lo = indptr[r], hi = indptr[r + 1];
        if (n_cols - (hi - lo) < k) {
            // not enough unseen columns; atomic: several rows may fail
#ifdef _OPENMP
#pragma omp atomic write
#endif
            status = 1;
            continue;
        }
        std::unordered_set<int32_t> excluded(indices + lo, indices + hi);
        excluded.reserve(static_cast<size_t>(hi - lo + k) * 2);
        std::mt19937_64 rng(seed ^ (0x9E3779B97F4A7C15ULL *
                                    (static_cast<uint64_t>(r) + 1)));
        std::uniform_int_distribution<int32_t> dist(0, n_cols - 1);
        int32_t* row_out = out + static_cast<int64_t>(r) * k;
        for (int32_t s = 0; s < k; ++s) {
            int32_t candidate = dist(rng);
            while (excluded.count(candidate)) {
                candidate = dist(rng);
            }
            excluded.insert(candidate);
            row_out[s] = candidate;
        }
    }
    return status;
}

// Temporal split guard (reference polara/lib/sampler.py:135-165): walk
// instances in descending priority; the first instance of each task joins
// the top sequence, later above-cutoff instances displace the earlier pick
// into the non-sequential ("future") set.  Returns counts via `counts`
// (top, low, nonseq); index buffers must hold n entries each.
void split_top_continuous(const int64_t* tasks, const double* priorities,
                          int64_t n, int64_t* top_idx, int64_t* low_idx,
                          int64_t* nonseq_idx, int64_t* counts) {
    std::vector<int64_t> order(n);
    std::iota(order.begin(), order.end(), int64_t{0});
    std::stable_sort(order.begin(), order.end(),
                     [priorities](int64_t a, int64_t b) {
                         return priorities[a] > priorities[b];
                     });

    std::unordered_map<int64_t, int64_t> top_of;
    std::unordered_set<int64_t> remaining(tasks, tasks + n);
    top_of.reserve(remaining.size() * 2);
    // first-occurrence order of tasks, to emit tops exactly like the
    // Python dict-insertion-ordered implementation
    std::vector<int64_t> task_order;
    task_order.reserve(remaining.size());

    int64_t n_nonseq = 0;
    int64_t consumed = 0;
    for (; consumed < n && !remaining.empty(); ++consumed) {
        const int64_t idx = order[consumed];
        const int64_t task = tasks[idx];
        auto it = top_of.find(task);
        if (it != top_of.end()) {
            nonseq_idx[n_nonseq++] = it->second;
            it->second = idx;
        } else {
            top_of.emplace(task, idx);
            task_order.push_back(task);
            remaining.erase(task);
        }
    }

    int64_t n_top = 0;
    for (const int64_t task : task_order) {
        top_idx[n_top++] = top_of[task];
    }
    int64_t n_low = 0;
    for (int64_t i = consumed; i < n; ++i) {
        low_idx[n_low++] = order[i];
    }
    counts[0] = n_top;
    counts[1] = n_low;
    counts[2] = n_nonseq;
}

// Contiguous reindexing of already-factorized codes grouped per row:
// given row-sorted (rows, cols) events, emit for every row the count of
// distinct cols (helper for session-length statistics at ingest scale).
void row_unique_counts(const int32_t* rows, const int32_t* cols,
                       int64_t nnz, int32_t n_rows, int64_t* out) {
    std::fill(out, out + n_rows, int64_t{0});
    int64_t e = 0;
    while (e < nnz) {
        const int32_t r = rows[e];
        std::unordered_set<int32_t> uniq;
        while (e < nnz && rows[e] == r) {
            uniq.insert(cols[e]);
            ++e;
        }
        out[r] = static_cast<int64_t>(uniq.size());
    }
}

// Per-group top-k selection: for every group (codes 0..n_groups-1) emit
// the event indices of its k largest values.  O(n log k) via per-group
// min-heaps — the scale path for holdout sampling over 100M+ event logs
// where a pandas groupby-nlargest stalls.  Ties prefer the LATER event
// (pandas nlargest keep='last' convention).
void group_top_k(const int32_t* groups, const double* values, int64_t n,
                 int32_t n_groups, int32_t k, int64_t* out_idx,
                 int64_t* out_count) {
    if (k <= 0) {
        std::fill(out_count, out_count + n_groups, int64_t{0});
        return;
    }
    using Entry = std::pair<double, int64_t>;  // (value, event index)
    auto worse = [](const Entry& a, const Entry& b) {
        // min-heap on value; among equal values the EARLIER event is
        // "worse" (gets evicted first), implementing keep-last
        if (a.first != b.first) return a.first > b.first;
        return a.second > b.second;
    };
    std::vector<std::vector<Entry>> heaps(n_groups);
    for (auto& heap : heaps) heap.reserve(k + 1);

    for (int64_t e = 0; e < n; ++e) {
        auto& heap = heaps[groups[e]];
        Entry entry{values[e], e};
        if (static_cast<int32_t>(heap.size()) < k) {
            heap.push_back(entry);
            std::push_heap(heap.begin(), heap.end(), worse);
        } else if (worse(entry, heap.front())) {
            std::pop_heap(heap.begin(), heap.end(), worse);
            heap.back() = entry;
            std::push_heap(heap.begin(), heap.end(), worse);
        }
    }

    int64_t cursor = 0;
    for (int32_t g = 0; g < n_groups; ++g) {
        out_count[g] = static_cast<int64_t>(heaps[g].size());
        for (const Entry& entry : heaps[g]) {
            out_idx[cursor++] = entry.second;
        }
    }
}

// Striped seen-bitmask packing of the JAX package's Pallas kernel
// (polara_tpu/ops/pallas.py; the CUDA kernel reads the natural layout of
// polara_tpu_torch/ops/fused_topk.py instead): item tile of `tile_n` columns, W=tile_n/32
// words; tile-offset o lives in word (o % W) at bit (o / W).
void pack_seen_bits(const int32_t* rows, const int32_t* cols, int64_t nnz,
                    int32_t n_rows, int32_t tile_n, int32_t n_words,
                    uint32_t* out) {
    const int32_t w = tile_n / 32;
    for (int64_t e = 0; e < nnz; ++e) {
        const int32_t tile = cols[e] / tile_n;
        const int32_t offset = cols[e] % tile_n;
        const int64_t word =
            static_cast<int64_t>(rows[e]) * n_words + tile * w + offset % w;
        out[word] |= (1u << (offset / w));
    }
}

}  // extern "C"
