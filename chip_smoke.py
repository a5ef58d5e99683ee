"""Drive the PyTorch/CUDA port (``polara_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. Build the CUDA kernels from ``polara_tpu_torch/csrc`` (nvcc, sm_90a),
   and beside them, in parallel, the kernel's measurement variants
   (``PHASE_VARIANTS``, ``SLICED_VARIANTS``); print ptxas's registers and
   spills, and require no spills in the k <= 32 instantiations of both
   score kernels (whole rank and sliced).
2. Kernel vs plain version on the card: the JAX package's kernel test
   shapes, the tiling's edge cases (``EDGE_CASES``, few-user grids
   included; integer factors bit-identical, Gaussian ones re-scored, and
   on each one item split, the rule's count and the largest giving
   identical ids and values), an integer tie case, a PAD case, a
   ``filter_seen=False`` case and the main path's shape.
3. The main path at ML-10M geometry (69,878 users x 10,677 items, ~10M
   events): seeded data on the card, one held-out event per user, dense
   block + bf16 power operator, PureSVD rank 50 by randomized subspace
   iteration, ``run_scoring_fused`` (popularity item order) ->
   ``metrics_core``.  Gates: the kernel ran, ids in range, ``fused_ok``,
   triplet residual, metric delta and top-10 overlap against exact f64
   factors from the Gram's eigendecomposition; two ``proj_chunk`` calls,
   and two COO ``mm``/``rmm`` calls, give identical bits.  At the main
   path's own inputs: the kernel against its plain version, its time, the
   times of its measurement variants (``phase_ms``), and ``proj_chunk``'s
   sorted segment sum beside three other routes (``projection_routes``).
4. Cross-validation at ML-1M geometry through the data model:
   ``run_cv_experiment`` over folds 1..5 with ``topk_test`` (top-10/5)
   for PureSVD and PureSVD-s (rank 50), MP and item-to-item, at
   ``test_ratio=0.2``, ``holdout_size=1``.  Gates: each fold's
   ``prepare()`` took the native holdout path, each SVD model launched
   the kernel in each fold, MP's fold-1 picks equal a plain stable-sort
   top-k, every metric finite.
5. The rank sweep of ``benchmarks/rank_sweep.py`` at ML-10M geometry:
   ``prepare()`` (``warm_start=False``, ``test_ratio=0.05``,
   ``holdout_size=1``), then ``find_optimal_svd_rank`` over ranks
   10..150 by ARHR, cold and warm with a rebuild.  Gates: the native
   library built and ``prepare()`` took its path, with the native
   selection equal to pandas' on the first 200k events; at least 15
   launches in the cold sweep; at ranks 10, 50 and 150 the kernel's
   picks from zero-padded factors equal the truncated factors' bit for
   bit; ``fused_ok`` and the triplet residual at rank 150; ScaledSVD
   launches the kernel and solves the scaled matrix; a Krylov build's
   residual and HR@10 against the subspace build's; a checkpoint round
   trip gives identical recommendations.
6. The mesh path at ML-10M geometry (phase 3's data and seed) over a
   (4, 1) ``users`` mesh and a (2, 2) ``users x model`` mesh, entries
   dealt to the visible cards in turn (all ``cuda:0`` on one card): the
   row-sharded dense block and bf16 copy solved with CholeskyQR2, then
   ``run_scoring_fused(mesh=...)`` on each mesh, counted.  Gates: launches
   = user shards x item shards x chunks; phase 3's quality bars for the
   mesh build; on one projection, both meshes' ids and values equal the
   single-device kernel's (``filter_seen`` True and False);
   ``full_train_step`` on the (4, 1) mesh gives the hit count of its
   factors scored on one device; ``SVDModel(data, mesh=...)`` caches a
   row-sharded block, launches 4 x chunks and matches one device's HR@10
   within 1e-3 and top-10 within 0.99 overlap.  Times: the builds,
   CholeskyQR2 at (users x 100), each route's scoring, one shard's kernel
   with its bound and the ``torch.topk`` route at its shape, and the
   two-stage merge.
7. The factor models on phase 3's data and split, scored through the
   kernel like PureSVD: iALS rank 50, 15 epochs (``benchmarks/
   bpr_quality.py``'s configuration) on the dense tier and on the event
   tier from one start, BPR rank 50 (lr 0.05, batch 4096, 10 epochs), PMF
   at its defaults and popularity; ``distributed_ials`` on a (4, 1) mesh
   against two single-device epochs, the iALS factors scored on (4, 1)
   and (2, 2) meshes, ``distributed_bpr("exact")`` against ``bpr_train``
   for two epochs; iALS warm start through the data model at ML-1M
   geometry.  Gates: the kernel ran for each model; ``fused_ok`` for iALS
   and BPR; iALS and BPR beat popularity's HR@10; BPR's batch AUC rises
   and ends above 0.85; PMF's RMSE falls over 5 epochs; the two iALS
   tiers agree (top-10 overlap, HR@10); the mesh trainers agree with one
   device's; the mesh scorings equal one device's ids and values; the
   warm-start metrics are finite and beat popularity.  Times: seconds
   per epoch, an iALS half-sweep split into its parts, event staging,
   BPR pairs/s, peak memory.
8. The tensor path: ``benchmarks/ml10m_coffee.py``'s CoFFee, mlrank (13,
   10, 2), 25 sweeps at most, growth tolerance 1e-4, through the data
   model at ML-10M geometry (one random held-out event per test user, 20%
   test users); the dense tensor is past the memory budget, so HOOI runs
   on the event tier (sorted segment sums), and scoring goes through the
   kernel.  Then ``find_optimal_tucker_ranks`` over that benchmark's
   grid, a rebuild at the best mlrank, PureSVD-50 (Krylov) for context;
   ``distributed_hooi`` on a (4, 1) mesh against ``hooi`` for 3 sweeps;
   ``CoffeeModel`` scored on (4, 1) and (2, 2) meshes; at ML-1M geometry
   the dense tier against the event tier and ``predict_feedback``.
   Gates: the kernel ran (build + evaluate, the rank search, each mesh:
   shards x chunks), ``fused_ok``, HR@10 above popularity's, two builds
   and two ``proj_chunk`` calls bit-identical, the tiers' principal
   angles < 1e-3 and |dHR@10| <= 1e-3, ``distributed_hooi``'s < 1e-4,
   mesh ids equal to one device's, predicted ratings among the trained
   ones.  Times: the build and its sweeps, one sweep split into segment
   sums / QR + SVD / small products, tuning, scoring, peak memory.
9. The serving entry point: ``ServingBundle`` over phase 3's PureSVD
   factors (projection), phase 7's iALS and BPR factors (fold-in) and
   phase 8's CoFFee model (``from_model``, value map) at the ML-10M
   catalog, batch 1,024, top-10 (``benchmarks/serving_throughput.py``):
   id lists of 100 events (bucket 128), of 50 and 200 (buckets 64 and
   256), rating dicts and dense profiles, counted.  Gates: the kernel ran
   for each bundle; each step's kernel against its plain version on the
   step's own inputs (integer-factor twins: ids identical for the
   projection steps; fold-in solves and trained factors: re-scored
   picks); a request that has seen all but 3 items gets them, then its
   seen items in ascending order (``lax.top_k``'s fill); save -> load
   gives identical ids.  Times per step: the whole call (host clock), the
   host assembly, the device part (CUDA events), the kernel alone.

10. The side-information path: ``benchmarks/hybrid_svd.py``'s HybridSVD
   (rank 30, ``features_weight`` 0.5 so ``L Lᵀ = S + I``, six power
   iterations, the synthetic PSD similarity of a 32-wide base drawn on
   the card) through ``SimilarityDataModel`` in phase 8's scenario at
   ML-10M geometry: the 10,677² Cholesky, the densified ``Rᵀ·L``
   operator, the projectors, scoring through the kernel over the left
   projector.  Beside it ScaledHybridSVD, SIM (dense ``profile @ S``),
   S = I against PureSVD-30 on the same split, a ``features_weight``
   change; KPMF (a genre-kNN Laplacian) and LCE at ML-1M geometry with
   known users; the item cold-start scenario at ML-10M geometry (20% of
   the items cold, synthetic genres: 19 labels, 1-3 per item) for MP,
   RND, SIM, PureSVD-50, PureSVD-s-50, HybridSVD-30 and LCE-10; the
   HybridSVD serving bundle at batch 1,024.  Gates: the kernel ran for
   each fused model and the bundle, ``fused_ok`` for both hybrids,
   KPMF and LCE, HybridSVD's HR@10 above popularity's, two ``proj_chunk`` calls
   bit-identical, S = I top-10 overlap >= 0.99 and |dHR@10| <= 1e-3,
   the refactorization and rebuild, SIM's picks equal a stable-sort
   top-k of its scores, KPMF's RMSE and LCE's objective not rising,
   every cold-start model's picks shaped and in range with finite
   metrics, PureSVD(cs) and HybridSVD(cs) above RND(cs) on hits,
   HybridSVD(cs)'s picks equal a stable-sort top-k of its scores, the
   bundle's kernel ids equal its plain version's on integer twins with
   left != right.  Times: the Cholesky, one operator ``mm``/``rmm``,
   the projector products, builds, warm scoring, ``profile @ S``, each
   cold-start model, the serving call, peak memory.

11. The beyond-memory streaming tier at Netflix geometry (480,189 x
   17,770, ~100M events; the dense f32 block would be 31.8 GiB, past the
   memory budget): seeded data on the card, one held-out event per user
   (``holdout_split``'s draws), training seen bits packed on the card in
   popularity order; three operators staged from the training events and
   timed: ``split_coo_operator`` at the JAX package's 2 GiB head budget
   and at the port's (a quarter of the free memory), and
   ``tiled_coo_operator``; PureSVD rank 50 through each by
   ``randomized_svd_krylov`` at depth 3 (``benchmarks/netflix_scale.py``),
   ``proj = u · diag(s)``, all users scored through the kernel in one
   launch, ids mapped back from popularity order.  Then
   ``distributed_chunked_rsvd`` (split head) on a (4, 1) mesh against the
   single-device build of the same solver, ``ImplicitALS(mesh=(4, 1))``
   at ML-10M geometry past a lowered budget (``distributed_ials_events``)
   against the single-device event tier, exact f64 factors from the Gram
   accumulated over dense f64 row blocks, and, with the operators freed,
   the dense route's Krylov build on the 34.1 GB block (timing only).
   Gates: each build launched the kernel, ids in range, ``fused_ok``, the
   triplet residual through the operator, metric delta (< 1e-3) and
   top-10 overlap (>= 0.98) against the exact factors, split vs tiled
   (overlap >= 0.99, singular values within 5e-3), two ``mm`` and two
   ``rmm`` calls of each operator and two split builds bit-identical, the
   mesh SVD (overlap >= 0.99, |dHR@10| <= 1e-3), the mesh iALS (item
   factors within 1e-4, |dHR@10| <= 2e-3), HR@10 above popularity's.
   Times: generation, seen-bit packing, staging, builds, warm scoring,
   one ``mm`` + ``rmm`` at width 100 per operator, the kernel at this
   shape with its bound, cuBLAS scores and ``torch.topk`` route at the
   scoring plan's chunk, the exact reference, the dense route, peak memory.

12. The evaluation protocols.  (a) ``LongTailMixin`` at ML-10M geometry
   (phase 3's data; ``long_tail_holdout``, ``head_feedback_frac`` 0.33,
   ``warm_start=False``, 20% test users, one top-rated held-out event
   each): PureSVD rank 50 through the kernel.  (b) On that split and
   those factors, ``SampledEvaluationSVDMixin`` with 999 unseen items per
   test user, registered from ``sample_row_wise`` and drawn on the fly by
   ``sampled_scores``.  (c) At ML-1M geometry, ``ml-1m.zip`` written and
   read back through ``get_movielens_data``; the EigenRec protocol of
   ``benchmarks/quality_ml1m.py:153-213`` (random 5-star holdouts,
   ``sample_unseen_interactions`` n_random 999, ScaledSVD rank 50 at
   ``col_scaling`` 1.0 and 0.5); contextual post-filtering by each event's
   first genre (``ItemPostFilteringData``, ``SVDModel`` rank 50 beside
   ``ItemPostFilteringMixin`` + ``SVDModel``).  Gates: every holdout item
   outside the short head (numpy, from the log); the kernel ran, ids in
   range, ``fused_ok``, HR@10 above popularity's; no sampled item seen or
   repeated (both routes, on the card); each registered rank equals the
   f64 count of candidates above the holdout (near ties excluded and
   counted); the routes' MRR@10 within 0.03; two fold-ins and two
   on-the-fly runs bit-identical; the sampled route and the contextual
   model launch no kernel, the plain model does; the loader's frames
   equal what was written; 999 candidates per user and MRR in (0, 1] for
   each scaling (whether 0.5 beats 1.0 is printed, not gated); the
   contextual picks lead with unseen upvoted items in descending
   unboosted score, no seen item, and HR@10 above the plain model's.
   Times: ``prepare()``, the build and the scoring, ``sample_row_wise``,
   ``sampled_scores``, ``inner_product_at``, the loader's read, unfused
   contextual vs fused plain scoring, peak memory.

13. Past the kernel's whole-rank staging.  (a) PureSVD rank 300 through
   ``evaluate()`` under the default route on phase 3's data and split
   (the data model: training events as its frame, the held-out events
   set as its holdout): the kernel walks the rank in 32-row steps.  (a')
   ``find_optimal_svd_rank`` over ranks (250, 300) on phase 5's data
   (a fixed-count build).
   (b) ``MyMediaLiteWrapper`` on (a)'s data through a stand-in for
   ``item_recommendation`` (``MML_STAND_IN``: the wrapper's command line,
   MyMediaLite's text layouts, reversed id mappings, factors saved by
   this script): WRMF rank 50 carrying phase 3's PureSVD-50 factors, and
   BPRMF rank 256 carrying (a)'s factors with the item log-popularity as
   its bias, 257 columns after the QR fold-in.  Gates: each launched the
   kernel; ids in range; the picks of the first 4,096 test users equal
   the plain version's bit for bit (rank 300, BPRMF); metric delta and
   top-10 overlap against exact f64 factors; rank 250's picks from the
   zero-padded factors equal the truncated ones' bit for bit; WRMF's raw
   factors land on their framework ids exactly, and after the QR its
   picks overlap PureSVD-50's >= 0.999 with HR@10 within 1e-4; BPRMF
   scores 257 columns and beats popularity's HR@10.  Times: the build,
   the exact reference, the sweep, each adapter step (CSV dump, the
   stand-in, the parse, the QR, the scoring), the kernel at 69,878 x
   10,677 x 300 with its bound, peak memory.

pandas is required (phases 4-13): without it the script exits non-zero
before phase 1.

Prints the card's name and power limit, a JSON line describing each
kernel (its time at the main path's inputs beside the plain version's,
its bound: the f32 FMA work at the card's peak from its SM count and
max SM clock, or the bytes at the HBM rate, whichever is larger; the
cuBLAS scores-only product as ``library_ms`` and the ``torch.topk``
route as ``topk_ms``; the SM clock under load; ``launches`` counts calls
of the C entry point in phase 3, each of which runs the panel transpose
and then the score kernel, and ``launches_by_path`` those of phases 3-13;
``sweep_top_rank`` the same fields at the sweep's rank-150 shape,
``mesh_shard`` at one shard of each mesh, ``tensor_scoring`` at CoFFee's
shape, ``serving_batch`` at one serving batch, ``hybrid_scoring`` at
HybridSVD's, ``netflix_scoring`` at phase 11's 480,189 users,
``rank_300`` at phase 13's rank (with ``variant_ms``: the resident-proj
build beside the library), ``main_k100`` and ``rank_300_k100`` at k =
100, and ``mesh_merge_ms``; each shape, and the main path's top level,
also carries the item split: ``splits`` (the rule's count),
``blocks_per_sm`` (the occupancy it came from) and ``unsplit_ms`` (the
same inputs with one split)), and as
the last line ``{"ok": true, "device": {...}}``.  Without CUDA, without
pandas, or without the package beside it, it exits non-zero and prints no
result.
"""
import gc
import importlib.util
import json
import subprocess
import sys
import time

import numpy as np

RANK, TOPK, POWER_ITERS, VERIFY_USERS = 50, 10, 6, 4096
KERNEL_SOURCE = "polara_tpu_torch/csrc/fused_topk.cu"
KERNEL_REPLACES = "polara_tpu/ops/pallas.py:45"
# the kernel's pick in each slot must score (in f64) within this of the
# plain pick, relative to the row's largest absolute score: f32 FMA
# chains over rank <= 50 drift ~1e-6 relative from cuBLAS's order
RESCORE_RTOL = 1e-5
# the kernel's tiling edges (64-user blocks, 128-item tiles, float4 rank
# steps, 32-slot lists): (seed, n_users, n_items, rank, k, n_valid,
# filter_seen); tests/test_torch_cuda.py runs the same shapes
EDGE_CASES = [
    (20, 65, 1000, 3, 33, 900, True),
    (21, 63, 1000, 1, 1, 1000, True),
    (22, 65, 777, 256, 128, 700, True),
    (23, 63, 300, 256, 1, 250, False),
    (24, 129, 1000, 3, 128, 999, True),
    (25, 64, 128, 1, 33, 128, True),
    # past the whole-rank staging (256): the rank walked in 32-row steps
    # of 256-item tiles, 257 and 520 ending on a partial step
    (26, 65, 1000, 257, 10, 900, True),
    (27, 129, 777, 300, 128, 700, True),
    (28, 63, 1000, 520, 1, 1000, False),
    (29, 200, 3000, 300, 10, 3000, True),
    # few users: grids the item split widens (1 user: a tile per split)
    (30, 1, 3000, 50, 10, 3000, True),
    (31, 16, 3000, 50, 10, 2900, True),
    (32, 63, 3000, 150, 33, 3000, True),
    (33, 64, 3000, 50, 128, 3000, False),
    (34, 65, 3000, 300, 10, 3000, True),
    (35, 1024, 10_677, 50, 10, 10_677, True),
]
# builds of fused_topk.cu that switch a part off (macros at its head),
# timed beside the kernel at the main path's inputs
PHASE_VARIANTS = {
    "sync_staging": ("POLARA_SYNC_STAGING",),
    "no_selection": ("POLARA_PHASE_NO_SELECTION",),
    "no_copy": ("POLARA_PHASE_NO_COPY",),
    "no_products": ("POLARA_PHASE_NO_PRODUCTS",),
    "transpose_only": ("POLARA_PHASE_TRANSPOSE_ONLY",),
}
# builds of the sliced path's alternatives, timed with PHASE_VARIANTS at
# phase 13's rank 300
SLICED_VARIANTS = {
    "proj_resident": ("POLARA_SLICED_PROJ_RESIDENT",),
}
# variants that must return the kernel's ids and values
EXACT_VARIANTS = ("sync_staging", "proj_resident")
HBM_BYTES_PER_S = 3.35e12   # H100 SXM data sheet
F32_LANES_PER_SM = 128      # Hopper: FP32 FMA lanes per SM


def log(msg: str) -> None:
    print(msg, flush=True)


class Timer:
    """CUDA-event stopwatch on the current stream (seconds)."""

    def __init__(self):
        import torch
        self._start = torch.cuda.Event(enable_timing=True)
        self._end = torch.cuda.Event(enable_timing=True)

    def __enter__(self):
        self._start.record()
        return self

    def __exit__(self, *exc):
        self._end.record()
        self._end.synchronize()
        self.seconds = self._start.elapsed_time(self._end) / 1e3


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def clocks_under_load(fn, seconds: float = 2.0) -> dict:
    """Median SM clock (MHz) and power draw (W) of card 0, sampled by
    nvidia-smi every 100 ms while ``fn`` runs back to back."""
    import torch
    proc = subprocess.Popen(
        ["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
    try:
        stop = time.perf_counter() + seconds
        while time.perf_counter() < stop:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        proc.terminate()
        text = proc.communicate(timeout=60)[0]
    samples = []
    for line in text.splitlines():
        try:
            samples.append([float(x) for x in line.split(",")])
        except ValueError:
            continue
    mhz, watts = zip(*samples) if samples else ((), ())
    return {"sm_mhz": float(np.median(mhz)) if mhz else None,
            "power_w": float(np.median(watts)) if watts else None,
            "samples": len(samples)}


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)
    log(f"  ok: {what}")


# --------------------------------------------------------------------------
# phase 2: kernel vs plain version
# --------------------------------------------------------------------------

def _compare(proj, items, bits, k, filter_seen=True, n_valid=None,
             exact=False):
    """Kernel and plain version on the same tensors; returns
    (id agreement, max |value diff| over finite slots)."""
    import torch
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference,
                                                 seen_mask)
    n_items = items.shape[0]
    n_valid = n_items if n_valid is None else n_valid
    kv, ki = fused_score_topk(proj, items, bits, k, filter_seen=filter_seen,
                              n_valid_cols=n_valid, return_values=True)
    pv, pi = fused_score_topk_reference(proj, items, bits, k,
                                        filter_seen=filter_seen,
                                        n_valid_cols=n_valid,
                                        return_values=True)
    if proj.is_cuda:
        torch.cuda.synchronize()
    check((ki == -1).eq(pi == -1).all().item(), "PAD slots agree")
    finite = pi >= 0
    if exact:
        check(torch.equal(ki, pi) and torch.equal(kv, pv),
              "ids and values identical (integer factors)")
    # kernel picks: in range, not seen, no repeats within a row
    picks = ki.long().clamp(min=0)
    check(((ki < n_valid) & (ki >= -1)).all().item(), "ids in range")
    if filter_seen:
        seen = seen_mask(bits, n_items).gather(1, picks) & finite
        check(not seen.any().item(), "no seen item picked")
    srt = torch.sort(torch.where(finite, ki, -1 - torch.arange(
        k, device=ki.device)), dim=1).values
    check(not (srt[:, 1:] == srt[:, :-1]).any().item(), "no repeated ids")
    # re-score both picks in f64, in row blocks
    worst = 0.0
    for lo in range(0, proj.shape[0], 8192):
        s = proj[lo:lo + 8192].double() @ items.double().T
        s[:, n_valid:] = 0.0
        scale = s.abs().max(dim=1, keepdim=True).values.clamp(min=1e-30)
        fin = finite[lo:lo + 8192]
        sk = s.gather(1, ki[lo:lo + 8192].long().clamp(min=0))
        sp = s.gather(1, pi[lo:lo + 8192].long().clamp(min=0))
        gap = torch.where(fin, (sk - sp).abs() / scale, 0.0)
        worst = max(worst, gap.max().item())
    check(worst <= RESCORE_RTOL,
          f"re-scored gap {worst:.2e} <= {RESCORE_RTOL:g} of the row scale")
    diff = torch.where(finite, (kv - pv).abs(), 0.0).max().item()
    agree = (ki == pi).float().mean().item()
    return agree, diff


def split_gate(proj, items, bits, k, filter_seen=True, n_valid=None):
    """One item split, the rule's count and the largest (a tile a split)
    give the same ids and values bit for bit (each score is one block's
    ``fmaf`` chain; the merge keeps the lower column among equal values).
    Returns the rule's count (None off the card)."""
    import torch
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 item_tiles, kernel_splits)
    if not proj.is_cuda:
        return None
    n_valid = items.shape[0] if n_valid is None else n_valid
    rule = kernel_splits(proj.device, proj.shape[0], proj.shape[1], k,
                         n_valid)
    got = {splits: fused_score_topk(proj, items, bits, k,
                                    filter_seen=filter_seen,
                                    n_valid_cols=n_valid, return_values=True,
                                    _splits=splits)
           for splits in (1, rule, item_tiles(n_valid, proj.shape[1]))}
    vals, ids = got[1]
    check(all(torch.equal(i, ids) and torch.equal(v, vals)
              for v, i in got.values()),
          f"item splits {sorted(got)} (rule {rule}): ids and values "
          "identical")
    return rule


def split_fields(proj, panel, bits, n_valid, k=TOPK, reps=10):
    """The item split at these inputs: the rule's count (``splits``), the
    occupancy it came from (``blocks_per_sm``), the split gate, and the
    time of the same inputs with one split (``unsplit_ms``)."""
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 kernel_blocks_per_sm)
    if not proj.is_cuda:
        return {"splits": None, "blocks_per_sm": None, "unsplit_ms": None}
    splits = split_gate(proj, panel, bits, k, n_valid=n_valid)
    return {"splits": splits,
            "blocks_per_sm": kernel_blocks_per_sm(proj.device, proj.shape[1],
                                                  k),
            "unsplit_ms": time_ms(lambda: fused_score_topk(
                proj, panel, bits, k, n_valid_cols=n_valid, _splits=1),
                reps)}


def _case_tensors(rs, n_users, n_items, rank, nnz, device, integer=False):
    import torch
    from polara_tpu_torch.ops.fused_topk import pack_seen_bits
    if integer:
        proj = rs.randint(0, 3, (n_users, rank)).astype(np.float32)
        items = rs.randint(0, 4, (n_items, rank)).astype(np.float32)
    else:
        proj = rs.randn(n_users, rank).astype(np.float32)
        items = rs.randn(n_items, rank).astype(np.float32)
    pairs = np.unique(np.stack([rs.randint(0, n_users, nnz),
                                rs.randint(0, n_items, nnz)], 1), axis=0) \
        if nnz else np.zeros((0, 2), np.int64)
    rows = torch.as_tensor(pairs[:, 0], device=device)
    cols = torch.as_tensor(pairs[:, 1], device=device)
    return (torch.as_tensor(proj, device=device),
            torch.as_tensor(items, device=device),
            pack_seen_bits(rows, cols, n_users, n_items))


def kernel_phase(device="cuda"):
    """Phase 2: the kernel against its plain version on the card."""
    grid = [  # (seed, n_users, n_items, rank, k, nnz) of the JAX tests
        (10, 8, 100, 4, 10, 50), (11, 33, 5000, 16, 20, 4000),
        (12, 130, 9000, 8, 1, 20_000), (13, 16, 4096, 8, 128, 1000),
        (14, 24, 300, 5, 7, 24 * 250)]
    agree = []
    for seed, n_users, n_items, rank, k, nnz in grid:
        log(f"case seed={seed} users={n_users} items={n_items} rank={rank} "
            f"k={k}")
        rs = np.random.RandomState(seed)
        proj, items, bits = _case_tensors(rs, n_users, n_items, rank, nnz,
                                          device)
        agree.append(_compare(proj, items, bits, k)[0])
    for seed, n_users, n_items, rank, k, n_valid, filter_seen in EDGE_CASES:
        for integer in (True, False):
            log(f"edge case seed={seed} users={n_users} items={n_items} "
                f"n_valid={n_valid} rank={rank} k={k} "
                f"filter_seen={filter_seen} "
                f"{'integer' if integer else 'gaussian'}")
            rs = np.random.RandomState(seed)
            proj, items, bits = _case_tensors(rs, n_users, n_items, rank,
                                              30 * n_users, device,
                                              integer=integer)
            _compare(proj, items, bits, k, filter_seen=filter_seen,
                     n_valid=n_valid, exact=integer)
            split_gate(proj, items, bits, k, filter_seen, n_valid)
    log("case integer ties (rank 1, 12 users x 1000 items, k=16)")
    rs = np.random.RandomState(7)
    proj, items, bits = _case_tensors(rs, 12, 1000, 1, 600, device,
                                      integer=True)
    _compare(proj, items, bits, 16, exact=True)
    log("case integer ties, rank 50, filter_seen=False")
    rs = np.random.RandomState(8)
    proj, items, bits = _case_tensors(rs, 40, 2000, 50, 0, device,
                                      integer=True)
    _compare(proj, items, bits, 128, filter_seen=False, exact=True)
    log("case integer ties, rank 300 (sliced), 40 users x 2000 items, k=128")
    rs = np.random.RandomState(9)
    proj, items, bits = _case_tensors(rs, 40, 2000, 300, 20_000, device,
                                      integer=True)
    _compare(proj, items, bits, 128, exact=True)
    log("case PAD beyond the catalog (35 items, k=40)")
    rs = np.random.RandomState(1)
    proj, items, bits = _case_tensors(rs, 16, 35, 12, 0, device)
    _compare(proj, items, bits, 40, filter_seen=False, n_valid=35)
    log("case filter_seen=False (16 users x 700 items, k=10)")
    rs = np.random.RandomState(0)
    proj, items, bits = _case_tensors(rs, 16, 700, 12, 300, device)
    _compare(proj, items, bits, 10, filter_seen=False)
    log("case main-path shape (69,878 users x 10,677 items, rank 50, k=10)")
    rs = np.random.RandomState(3)
    proj, items, bits = _case_tensors(rs, 69_878, 10_677, RANK, 10_000_000,
                                      device)
    agree.append(_compare(proj, items, bits, TOPK)[0])
    log(f"exact id agreement on random cases: "
        f"{', '.join(f'{a:.4f}' for a in agree)}")


# --------------------------------------------------------------------------
# phase 3: the main path
# --------------------------------------------------------------------------

def holdout_split(rows: np.ndarray, cols: np.ndarray, seed: int = 7):
    """One seeded held-out event per user (rows sorted), as
    ``bench.py:_holdout_split``."""
    uniq, start, counts = np.unique(rows, return_index=True,
                                    return_counts=True)
    rs = np.random.RandomState(seed)
    pick = start + (rs.rand(len(uniq)) * counts).astype(np.int64)
    hold_mask = np.zeros(len(rows), dtype=bool)
    hold_mask[pick] = True
    return uniq, cols[pick], hold_mask


def _hit_metrics(recs, hold_items):
    """HR@k and NDCG@k of one held-out item per user via metrics_core."""
    import torch
    from polara_tpu_torch.evaluation.metrics import metrics_core
    n = recs.shape[0]
    ones = torch.ones((n, 1), dtype=torch.bool, device=recs.device)
    out = metrics_core(recs, hold_items[:, None],
                       torch.ones((n, 1), dtype=torch.float64,
                                  device=recs.device), ones, ones,
                       topk=recs.shape[1], switch_positive=0.0,
                       alternative=True, has_split=False, penalty=0.0)
    return out["hr"].item(), out["ndcg"].item()


def main_path(geometry, device="cuda", verify_users=VERIFY_USERS,
              trained=None):
    """Phase 3.  Returns the measured fields; raises on a failed gate
    (except the kernel launch count, which the caller checks).  The item
    factors go to ``trained["svd"]`` when a dict is given (phase 9 serves
    them)."""
    import torch
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.models.svd import SVDModel
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference,
                                                 pack_seen_bits)
    from polara_tpu_torch.ops.rsvd import randomized_svd
    from polara_tpu_torch.ops.scoring import (ChunkedTestData, run_scoring,
                                              run_scoring_fused)
    from polara_tpu_torch.ops.sparse import (CooMatrix, dense_operator,
                                             dense_power_operator)

    n_users, n_items = geometry["n_users"], geometry["n_items"]
    out = {}
    fused_score_topk.launches = 0
    # ---- the main path, as a user drives it
    with Timer() as t:
        rows_d, cols_d, vals_d = make_realistic_coo_device(
            **geometry, seed=0, device=device)
        torch.cuda.synchronize()
    out["data_gen_s"] = t.seconds
    rows, cols, vals = (x.cpu().numpy() for x in (rows_d, cols_d, vals_d))
    log(f"  {len(rows)} events, {n_users} x {n_items}")
    hold_users, hold_items, hold_mask = holdout_split(rows, cols)
    check(len(hold_users) == n_users, "every user holds out one event")
    keep = ~hold_mask
    with Timer() as t:
        matrix = CooMatrix.from_numpy(rows[keep], cols[keep], vals[keep],
                                      (n_users, n_items), device=device)
        dense = matrix.to_dense()
        plan = ChunkedTestData.build(rows[keep], cols[keep], vals[keep],
                                     n_users=n_users, n_items=n_items,
                                     device=device)
        perm, inv = plan.pop_order(n_items)
        for c in range(len(plan.chunks)):
            plan.seen_bits(c, n_items, col_map=inv,
                           map_token=("pop", n_items))
    out["staging_s"] = t.seconds
    log(f"  chunk plan: {len(plan.chunks)} chunk(s) x {plan.chunk_users}")
    with Timer() as t:
        result = randomized_svd(dense_operator(dense), RANK,
                                n_iter=POWER_ITERS, tol=None, seed=0,
                                power_operator=dense_power_operator(dense))
    out["build_s"] = t.seconds
    v = result.v.contiguous()
    if trained is not None:
        trained["svd"] = v
    params = {"item_factors": v, "item_panel": v}
    with Timer() as t:
        recs = run_scoring_fused(plan, SVDModel.proj_chunk, params, TOPK,
                                 n_valid_cols=n_items, on_device=True,
                                 item_order="popularity")
    out["score_kernel_s"] = t.seconds
    hold_items_d = torch.as_tensor(hold_items, device=device)
    hr, ndcg = _hit_metrics(recs, hold_items_d)
    out["launches"] = fused_score_topk.launches
    out.update(hr10=hr, ndcg10=ndcg)
    log(f"  HR@{TOPK} {hr:.5f}  NDCG@{TOPK} {ndcg:.5f}")

    # ---- checks
    check(tuple(recs.shape) == (n_users, TOPK), "recommendation shape")
    check(bool(((recs >= 0) & (recs < n_items)).all()),
          f"every id in [0, {n_items})")
    with Timer() as t:
        plain = run_scoring(plan, SVDModel.score_chunk, params, TOPK,
                            n_valid_cols=n_items, on_device=True)
    out["score_plain_s"] = t.seconds
    out["plain_exact_agreement"] = (plain == recs).float().mean().item()
    # warm repeats: the first calls above include one-time set-up (CUDA
    # library handles, the kernel's module load); plain before kernel, so
    # the two routes run in turns
    with Timer() as t:
        randomized_svd(dense_operator(dense), RANK, n_iter=POWER_ITERS,
                       tol=None, seed=0,
                       power_operator=dense_power_operator(dense))
    out["build_warm_s"] = t.seconds
    with Timer() as t:
        run_scoring(plan, SVDModel.score_chunk, params, TOPK,
                    n_valid_cols=n_items, on_device=True)
    out["score_plain_warm_s"] = t.seconds
    with Timer() as t:
        run_scoring_fused(plan, SVDModel.proj_chunk, params, TOPK,
                          n_valid_cols=n_items, on_device=True,
                          item_order="popularity")
    out["score_kernel_warm_s"] = t.seconds

    # fused_ok: kernel picks vs the plain version's on the first users,
    # re-scored in f64 (bench.py:253-284)
    head = plan.chunks[0]
    proj_all = SVDModel.proj_chunk(params, head)
    proj_head = proj_all[:verify_users]
    sel = head.valid & (head.rows < verify_users)
    bits_head = pack_seen_bits(head.rows[sel], head.cols[sel],
                               proj_head.shape[0], n_items)
    plain_head = fused_score_topk_reference(proj_head, v, bits_head, TOPK)
    s64 = proj_head.double() @ v.double().T
    s_plain = s64.gather(1, plain_head.long())
    s_kern = s64.gather(1, recs[:verify_users].long())
    scale = max(s_plain.abs().max().item(), 1e-6)
    gap = (s_plain - s_kern).abs().max().item() / scale
    out["fused_max_gap"] = gap
    out["fused_exact_agreement"] = (
        plain_head == recs[:verify_users]).float().mean().item()
    out["fused_ok"] = gap < 1e-3
    check(out["fused_ok"], f"fused_ok: re-scored gap {gap:.2e} < 1e-3 "
          f"(exact agreement {out['fused_exact_agreement']:.4f})")

    # triplet residual |A v - s u| / s_1
    resid = dense @ result.v - result.u * result.s[None, :]
    out["triplet_residual"] = (torch.linalg.norm(resid, dim=0)
                               / result.s[0]).max().item()
    check(out["triplet_residual"] < 1e-2,
          f"max triplet residual {out['triplet_residual']:.3e} < 1e-2")

    # exact f64 factors from the Gram's eigendecomposition
    with Timer() as t:
        d64 = dense.double()
        gram = d64.T @ d64
        del d64
        evals, evecs = torch.linalg.eigh(gram)
        v_exact = evecs[:, -RANK:].flip(1)
        s_exact = evals[-RANK:].flip(0).clamp(min=0).sqrt()
    out["exact_factor_s"] = t.seconds
    out["sv_max_rel_err"] = ((result.s.double() - s_exact).abs()
                             / s_exact).max().item()
    v_ex = v_exact.float().contiguous()
    recs_ex = run_scoring_fused(plan, SVDModel.proj_chunk,
                                {"item_factors": v_ex, "item_panel": v_ex},
                                TOPK, n_valid_cols=n_items, on_device=True,
                                item_order="popularity")
    hr_ex, ndcg_ex = _hit_metrics(recs_ex, hold_items_d)
    out.update(hr10_exact=hr_ex, ndcg10_exact=ndcg_ex)
    out["metric_delta_vs_exact"] = max(abs(hr - hr_ex), abs(ndcg - ndcg_ex))
    overlap = ((recs[:, :, None] == recs_ex[:, None, :]).sum((1, 2))
               .double() / TOPK).mean().item()
    out["top10_overlap"] = overlap
    log(f"  exact f64 factors: HR@{TOPK} {hr_ex:.5f} NDCG@{TOPK} "
        f"{ndcg_ex:.5f}; singular values max rel err "
        f"{out['sv_max_rel_err']:.2e}")
    check(out["metric_delta_vs_exact"] < 1e-3,
          f"metric_delta_vs_exact {out['metric_delta_vs_exact']:.2e} < 1e-3")
    check(overlap >= 0.99, f"top-{TOPK} overlap {overlap:.5f} >= 0.99")

    # ---- kernel vs plain version on the main path's own inputs, gated as
    # in phase 2 (all users, popularity-ordered panel)
    panel = v.index_select(0, torch.as_tensor(perm, device=device))
    proj = proj_all.contiguous()
    bits = plan.seen_bits(0, n_items, col_map=inv,
                          map_token=("pop", n_items))
    agree, out["max_abs_err"] = _compare(proj, panel, bits, TOPK,
                                         n_valid=n_items)
    out["main_inputs_exact_agreement"] = agree
    out["kernel_ms"] = time_ms(lambda: fused_score_topk(
        proj, panel, bits, TOPK, n_valid_cols=n_items, tile_skip=True), 10)
    out["plain_ms"] = time_ms(lambda: fused_score_topk_reference(
        proj, panel, bits, TOPK, n_valid_cols=n_items), 3)
    out["kernel_clocks"] = clocks_under_load(lambda: fused_score_topk(
        proj, panel, bits, TOPK, n_valid_cols=n_items))
    log(f"  kernel {out['kernel_ms']:.3f} ms vs plain {out['plain_ms']:.3f} "
        f"ms at {proj.shape[0]} users; max |value diff| "
        f"{out['max_abs_err']:.2e}")
    out.update(split_fields(proj, panel, bits, n_items))
    out["k100"] = k_fields(proj, panel, bits, n_items, 100)
    log(f"  kernel at k=100: {json.dumps(out['k100'])}")
    # the variants launch only on the card (None in a CPU rehearsal)
    out["phase_ms"] = (phase_split(proj, panel, bits, n_items)
                       if proj.is_cuda else None)
    # the kernel's least work: one FMA per (user, valid item, rank step);
    # each input read once (proj, the valid panel rows, the seen words they
    # need), each output written once
    out["kernel_flop"] = 2 * proj.shape[0] * n_items * RANK
    out["kernel_bytes"] = 4 * (proj.numel() + n_items * RANK
                               + proj.shape[0] * -(-n_items // 32)
                               + 2 * proj.shape[0] * TOPK)
    out["stage_ms"] = stage_breakdown(dense, params, head, proj, panel, bits)
    out["projection_routes"] = projection_routes(head, v)
    # C2: the card's projections and COO products give the same bits on
    # every call
    check(torch.equal(SVDModel.proj_chunk(params, head),
                      SVDModel.proj_chunk(params, head)),
          "two proj_chunk calls give bit-identical projections")
    op = matrix.operator()
    check(torch.equal(op.mm(v), op.mm(v))
          and torch.equal(op.rmm(result.u), op.rmm(result.u)),
          "two COO mm and two COO rmm calls give bit-identical products")
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    return out


def projection_routes(chunk, v, reps=10):
    """``proj = R_chunk · V`` by the sorted segment sum that
    ``SVDModel.proj_chunk`` runs and by three other routes at the main
    path's inputs: warm ms (CUDA events), whether two calls give the same
    bits, and the largest difference from the segment sum's result."""
    import torch
    from polara_tpu_torch.models.svd import SVDModel
    n_rows = chunk.users.shape[0]
    rows = torch.where(chunk.valid, chunk.rows, n_rows - 1)
    vals = torch.where(chunk.valid, chunk.vals, 0.0)

    def terms():
        return vals[:, None] * v[chunk.cols]

    def empty():
        return torch.zeros((n_rows, v.shape[1]), dtype=v.dtype,
                           device=v.device)

    def csr():
        counts = torch.bincount(rows, minlength=n_rows)
        crow = torch.cat([counts.new_zeros(1), counts.cumsum(0)])
        return torch.sparse_csr_tensor(crow, chunk.cols, vals,
                                       size=(n_rows, v.shape[0]),
                                       check_invariants=False) @ v

    routes = {
        "segment_reduce": lambda: SVDModel.proj_chunk({"item_factors": v},
                                                      chunk),
        "csr_sparse_mm": csr,
        "index_put_accumulate": lambda: empty().index_put_(
            (rows,), terms(), accumulate=True),
        "index_add": lambda: empty().index_add_(0, rows, terms()),
    }
    want = routes["segment_reduce"]()
    out = {}
    for name, fn in routes.items():
        first, second = fn(), fn()
        out[name] = {"ms": time_ms(fn, reps) if v.is_cuda else None,
                     "bit_reproducible": bool(torch.equal(first, second)),
                     "max_abs_diff_vs_segment_reduce":
                         (first - want).abs().max().item()}
    log("  proj_chunk routes: " + json.dumps(out))
    return out


def phase_split(proj, panel, bits, n_valid, reps=10):
    """Warm ms of the kernel's C entry point in the library the port loads
    (``full``) and in each of ``PHASE_VARIANTS``, at these inputs: two
    rounds, the second in reverse order, averaged.  The sync-staging
    variant must return what the kernel returns."""
    import torch
    from polara_tpu_torch.ops._cuda_build import load_library
    from polara_tpu_torch.ops.fused_topk import fused_score_topk, panel_columns
    n_users, rank = proj.shape
    vals = torch.empty((n_users, TOPK), dtype=torch.float32,
                       device=proj.device)
    idx = torch.empty((n_users, TOPK), dtype=torch.int32, device=proj.device)
    items_t = torch.empty((rank, panel_columns(n_valid, rank)),
                          dtype=torch.float32, device=proj.device)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {"full": load_library()}
    libs.update({name: load_library(defines)
                 for name, defines in PHASE_VARIANTS.items()})

    def call(lib):
        err = lib.polara_fused_score_topk(
            proj.data_ptr(), panel.data_ptr(), items_t.data_ptr(), None,
            bits.data_ptr(), vals.data_ptr(), idx.data_ptr(), None, None,
            n_users, panel.shape[0], rank, bits.shape[1], n_valid, TOPK, 1,
            1, stream)
        if err:
            raise RuntimeError(f"kernel variant failed: cudaError_t {err}")

    call(libs["sync_staging"])
    torch.cuda.synchronize()
    want_vals, want_idx = fused_score_topk(proj, panel, bits, TOPK,
                                           n_valid_cols=n_valid,
                                           return_values=True)
    check(torch.equal(idx, want_idx) and torch.equal(vals, want_vals),
          "sync-staging variant returns the kernel's ids and values")
    times = dict.fromkeys(libs, 0.0)
    for order in (list(libs), list(libs)[::-1]):
        for name in order:
            times[name] += time_ms(lambda: call(libs[name]), reps) / 2
    log("  kernel phases (ms): " + ", ".join(f"{k} {t:.3f}"
                                             for k, t in times.items()))
    return times


def stage_breakdown(dense, params, head, proj, panel, bits, reps=10):
    """Warm CUDA-event times (ms) of the main path's stages, one at a
    time, at the main path's shapes."""
    import torch
    from polara_tpu_torch.models.svd import SVDModel
    from polara_tpu_torch.ops.fused_topk import seen_mask
    from polara_tpu_torch.ops.rsvd import randomized_svd
    from polara_tpu_torch.ops.sparse import (dense_operator,
                                             dense_power_operator)
    n_users, n_items = dense.shape
    block = RANK + max(10, RANK)        # randomized_svd's default block
    gen = torch.Generator(device=dense.device).manual_seed(0)
    tall = torch.randn((n_users, block), generator=gen, device=dense.device)
    wide = torch.randn((n_items, block), generator=gen, device=dense.device)
    full, low = dense_operator(dense), dense_power_operator(dense)
    rr = torch.randn((block, n_items), generator=gen, device=dense.device)

    def topk_baseline():
        s = proj @ panel.T
        s.masked_fill_(seen_mask(bits, n_items), -torch.inf)
        return torch.topk(s, TOPK, dim=1)

    stages = {
        "rsvd_total": lambda: randomized_svd(
            full, RANK, n_iter=POWER_ITERS, tol=None, seed=0,
            power_operator=dense_power_operator(dense)),
        "bf16_cast": lambda: dense_power_operator(dense),
        "panel_qr": lambda: torch.linalg.qr(tall),
        "bf16_A_X": lambda: low.mm(wide),
        "bf16_At_X": lambda: low.rmm(tall),
        "f32_A_X": lambda: full.mm(wide),
        "f32_At_X": lambda: full.rmm(tall),
        "rayleigh_ritz_svd": lambda: torch.linalg.svd(rr,
                                                      full_matrices=False),
        "proj_chunk": lambda: SVDModel.proj_chunk(params, head),
        "cublas_scores_only": lambda: proj @ panel.T,
        "topk_baseline": topk_baseline,
    }
    times = {name: time_ms(fn, 3 if name == "rsvd_total" else reps)
             for name, fn in stages.items()}
    log("  stages (ms): " + ", ".join(f"{k} {t:.3f}"
                                      for k, t in times.items()))
    return times


# --------------------------------------------------------------------------
# phases 4 and 5: the data model, cross-validation and the rank sweep
# --------------------------------------------------------------------------

def wall() -> float:
    """Host clock after the card's queued work is done."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return time.perf_counter()


def finite_table(table, undefined=("true_negative",)) -> bool:
    """Every metric of a consolidated table is finite, except the columns
    that are undefined without a positivity split (all NaN there)."""
    for column in table.columns:
        values = table[column].to_numpy(dtype=np.float64)
        if column[-1] in undefined and np.isnan(values).all():
            continue
        if not np.isfinite(values).all():
            return False
    return True


def popularity_plain_topk(data, model, k):
    """Plain picks of the popularity baseline: training counts per item,
    seen test items at -inf, a stable descending sort."""
    itemid = data.fields.itemid
    counts = np.bincount(data.training[itemid].to_numpy(),
                         minlength=data.get_test_shape()[1])
    (rows, items, _), (n_users, n_items), _ = model._get_test_data()
    scores = np.broadcast_to(counts.astype(np.float64),
                             (n_users, n_items)).copy()
    scores[rows, items] = -np.inf
    return np.argsort(-scores, axis=1, kind="stable")[:, :k]


def cv_phase(geometry, device="cuda", folds=(1, 2, 3, 4, 5)):
    """Phase 4: ``run_cv_experiment`` over five folds with ``topk_test`` at
    top-10/5 for PureSVD, PureSVD-s (rank 50), MP and item-to-item, through
    the data model.  Returns the table and the measured fields; raises on
    a failed gate except the launch counts, which the caller checks."""
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.evaluation.engine import (run_cv_experiment,
                                                    topk_test)
    from polara_tpu_torch.models import (CooccurrenceModel,
                                         PopularityModel, ScaledSVD,
                                         SVDModel)
    from polara_tpu_torch.ops.fused_topk import fused_score_topk

    frame = events_frame(*make_realistic_coo_device(**geometry, seed=0,
                                                    device=device))
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.test_ratio = 0.2
    data.holdout_size = 1
    models = [SVDModel(data, device=device), ScaledSVD(data, device=device),
              PopularityModel(data, device=device),
              CooccurrenceModel(data, device=device)]
    for model in models:
        model.verbose = False
    for model in models[:2]:
        model.rank = RANK
    out = {"folds": {}}
    state = {"t": wall()}

    def fold_experiment(models, **kwargs):
        fold = data.test_fold
        entered = wall()
        record = {"holdout_path": data.holdout_path,
                  "update_and_build_s": entered - state["t"],
                  "build_s": {m.method: m.training_time[-1]
                              for m in models if m.training_time}}
        # each model's recommendations first, counting its launches
        # (topk_test then slices the cached top-10)
        record["launches"] = {}
        for model in models:
            before = fused_score_topk.launches
            model._ensure_recommendations()
            record["launches"][model.method] = (fused_score_topk.launches
                                                - before)
        if fold == 1:
            pop = models[2]
            plain = popularity_plain_topk(data, pop, TOPK)
            record["popularity_plain_equal"] = bool(np.array_equal(
                pop.recommendations[:, :TOPK], plain))
        scored = wall()
        table = topk_test(models, **kwargs)
        state["t"] = wall()
        record["scoring_s"] = scored - entered
        record["topk_test_s"] = state["t"] - scored
        out["folds"][fold] = record
        return table

    fused_score_topk.launches = 0
    t0 = wall()
    table = run_cv_experiment(models, folds=list(folds),
                              fold_experiment=fold_experiment,
                              topk_list=[10, 5])
    out["cv_s"] = wall() - t0
    out["launches"] = fused_score_topk.launches
    for fold, record in out["folds"].items():
        log(f"  fold {fold}: " + json.dumps(record))
    check(all(r["holdout_path"] == "native" for r in out["folds"].values()),
          "every fold's prepare() took the native holdout path")
    check(out["folds"][folds[0]]["popularity_plain_equal"],
          "MP picks on fold 1 equal the plain stable-sort top-k")
    check(finite_table(table), "every metric finite")
    hr10 = table[("relevance", "hr")].xs(10, level="top-n")
    out["hr10"] = {k: float(v) for k, v in
                   hr10.groupby(level="model").mean().items()}
    log(f"  mean HR@10 over folds: {json.dumps(out['hr10'])}")
    return out


def triplet_residual(dense, v, s) -> float:
    """max over columns of ``‖Aᵀ(A v)/s − s v‖ / s₁``: the residual of the
    triplet (u = A v / s, s, v) on the side the solve does not fix."""
    import torch
    av = dense @ v
    resid = (dense.T @ av) / s[None, :] - v * s[None, :]
    return (torch.linalg.norm(resid, dim=0) / s[0]).max().item()


def sweep_phase(geometry, device="cuda", ranks=tuple(range(10, 160, 10)),
                verify_users=VERIFY_USERS):
    """Phase 5: the rank sweep of ``benchmarks/rank_sweep.py`` at this
    geometry, through ``find_optimal_svd_rank``, cold then warm with a
    rebuild; then ScaledSVD, a Krylov build and a checkpoint round trip on
    the same data.  Raises on a failed gate except the sweep's launch
    count, which the caller checks."""
    import tempfile
    from pathlib import Path

    import torch
    from polara_tpu_torch import native
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.data.dataset import native_top_positions
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.evaluation.pipelines import (
        evaluate_models, find_optimal_svd_rank)
    from polara_tpu_torch.models import ScaledSVD, SVDModel
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference)

    out = {}
    t0 = wall()
    frame = events_frame(*make_realistic_coo_device(**geometry, seed=0,
                                                    device=device))
    out["data_s"] = wall() - t0
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.warm_start = False
    data.test_ratio = 0.05
    data.holdout_size = 1
    t0 = wall()
    data.prepare()
    out["prepare_s"] = wall() - t0
    out["holdout_path"] = data.holdout_path
    out["n_holdout"] = int(len(data.test.holdout))
    log(f"  prepare {out['prepare_s']:.2f} s ({out['holdout_path']} "
        f"holdout path, {out['n_holdout']} holdout events)")
    # (a) the native selection against pandas on the frame's head
    check(native.native_available(),
          f"native library built ({native.build_error[-200:]!r})")
    check(out["holdout_path"] == "native",
          "prepare() took the native holdout path")
    head = frame.iloc[:200_000]
    want = head["rating"].groupby(head["userid"], sort=False,
                                  group_keys=False).nlargest(
        1, keep="last").index.to_numpy()
    got = head.index.to_numpy()[native_top_positions(
        head["userid"].to_numpy(), head["rating"].to_numpy(), 1)]
    check(np.array_equal(got, want),
          f"native selection == pandas nlargest on the first {len(head)} "
          "events, row for row")

    rank_s = {}

    def timed_evaluator(model, target, **kwargs):
        t = wall()
        result = evaluate_models(model, target, **kwargs)
        rank_s[model.rank] = wall() - t
        return result

    model = SVDModel(data, device=device)
    model.verbose = False
    fused_score_topk.launches = 0
    t0 = wall()
    best, scores = find_optimal_svd_rank(model, list(ranks), "arhr",
                                         return_scores=True,
                                         evaluator=timed_evaluator)
    out["cold_s"] = wall() - t0
    out["launches"] = fused_score_topk.launches
    out["cold_build_s"] = model.training_time[-1]
    out["cold_rank_s"] = dict(rank_s)
    out["svd_info"] = model.svd_info
    model._is_ready = False
    t0 = wall()
    best_warm, scores_warm = find_optimal_svd_rank(
        model, list(ranks), "arhr", return_scores=True,
        evaluator=timed_evaluator)
    out["warm_s"] = wall() - t0
    out["warm_build_s"] = model.training_time[-1]
    out["warm_rank_s"] = dict(rank_s)
    out["warm_svd_info"] = model.svd_info
    out["arhr"] = {int(r): float(v) for r, v in scores.items()}
    out["best_rank"] = int(best)
    log(f"  sweep cold {out['cold_s']:.2f} s (build "
        f"{out['cold_build_s']:.2f} s), warm {out['warm_s']:.2f} s (build "
        f"{out['warm_build_s']:.2f} s); best rank {best}; tolerance path "
        f"iterations (block, count): {out['svd_info']['iterations']}, "
        f"converged {out['svd_info']['converged']}")
    log(f"  ARHR per rank: {json.dumps(out['arhr'])}")
    check(all(np.isfinite(v) for v in out["arhr"].values()),
          "ARHR finite at every rank")
    check(best_warm == best and np.allclose(scores_warm.values,
                                            scores.values, atol=1e-3),
          "the warm sweep repeats the cold one within 1e-3")

    # (c) the kernel: zero-padded factors pick as the truncated ones
    top = max(ranks)
    v_top = model.factors[data.fields.itemid].contiguous()
    plan = model._test_plan
    chunk = plan.chunks[0]
    n_items = v_top.shape[0]
    bits = plan.seen_bits(0, n_items)
    padded_rank_gates(plan, v_top, (10, 50, top))

    # (d) fused_ok at the top rank over the first test users
    params = {"item_factors": v_top, "item_panel": v_top}
    proj = SVDModel.proj_chunk(params, chunk).contiguous()
    users = min(verify_users, plan.n_users)
    kv, ki = fused_score_topk(proj[:users].contiguous(), v_top,
                              bits[:users].contiguous(), TOPK,
                              n_valid_cols=n_items, return_values=True)
    pv, pi = fused_score_topk_reference(proj[:users], v_top, bits[:users],
                                        TOPK, n_valid_cols=n_items,
                                        return_values=True)
    s64 = proj[:users].double() @ v_top.double().T
    s_plain, s_kern = s64.gather(1, pi.long()), s64.gather(1, ki.long())
    scale = max(s_plain.abs().max().item(), 1e-6)
    gap = (s_plain - s_kern).abs().max().item() / scale
    out["fused_max_gap"] = gap
    out["fused_exact_agreement"] = (ki == pi).float().mean().item()
    out["max_abs_err"] = (kv - pv).abs().max().item()
    check(gap < 1e-3, f"rank {top} fused_ok: re-scored gap {gap:.2e} < "
          f"1e-3 over {users} users (exact agreement "
          f"{out['fused_exact_agreement']:.4f})")

    # (e) the top-rank build's triplet residual
    dense = model.get_training_matrix(dense=True)
    s_top = model.factors["singular_values"]
    out["triplet_residual"] = triplet_residual(dense, v_top, s_top)
    check(out["triplet_residual"] < 1e-2, f"rank {top} max triplet "
          f"residual {out['triplet_residual']:.3e} < 1e-2")

    # the kernel at the sweep's top-rank shape
    out["kernel"] = sweep_kernel_fields(proj, v_top, bits, n_items)

    # (f) ScaledSVD on the same data
    scaled = ScaledSVD(data, device=device)
    scaled.verbose = False
    scaled.rank = RANK
    scaled.col_scaling = 0.4
    before = fused_score_topk.launches
    out["scaled_hr10"] = scaled.evaluate("relevance").hr
    out["scaled_launches"] = fused_score_topk.launches - before
    out["scaled_build_s"] = scaled.training_time[-1]
    out["scaled_svd_info"] = scaled.svd_info
    check(out["scaled_launches"] > 0,
          f"ScaledSVD launched the kernel ({out['scaled_launches']}x)")
    scaled_dense = data._device_matrix_cache[scaled._last_dense_key]
    out["scaled_triplet_residual"] = triplet_residual(
        scaled_dense, scaled.factors[data.fields.itemid],
        scaled.factors["singular_values"])
    check(out["scaled_triplet_residual"] < 1e-2,
          f"ScaledSVD triplet residual on the scaled matrix "
          f"{out['scaled_triplet_residual']:.3e} < 1e-2")

    # (g) a Krylov build against a subspace build at rank 50
    hr = {}
    for method in ("subspace", "krylov"):
        m = SVDModel(data, device=device)
        m.verbose = False
        m.rank = RANK
        m.svd_method = method
        hr[method] = m.evaluate("relevance").hr
        out[f"{method}_build_s"] = m.training_time[-1]
        out[f"{method}_triplet_residual"] = triplet_residual(
            dense, m.factors[data.fields.itemid], m.factors["singular_values"])
    out["hr10_subspace"], out["hr10_krylov"] = hr["subspace"], hr["krylov"]
    check(out["krylov_triplet_residual"] < 1e-2, f"Krylov triplet residual "
          f"{out['krylov_triplet_residual']:.3e} < 1e-2")
    check(abs(hr["krylov"] - hr["subspace"]) <= 1e-3,
          f"Krylov HR@10 {hr['krylov']:.5f} within 1e-3 of the subspace "
          f"build's {hr['subspace']:.5f}")

    # (h) save -> load into a fresh model; deterministic scatters, so
    # both scorings sum every projection in the same order
    build_dir = Path(__file__).resolve().parent / "polara_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        path = str(Path(tmp) / "sweep_factors.npz")
        model.save(path)
        fresh = SVDModel(data, device=device)
        fresh.verbose = False
        meta = fresh.load(path)
    same_factors = all(
        (a is None and b is None) or torch.equal(a, b)
        for a, b in ((model.factors[k], fresh.factors[k])
                     for k in model.factors))
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        model._recommendations = None
        same_recs = np.array_equal(model.recommendations,
                                   fresh.recommendations)
    finally:
        torch.use_deterministic_algorithms(False)
    check(same_factors and meta.get("rank") == top and same_recs,
          "save -> load into a fresh model: identical factors and "
          "recommendations")
    return out


def padded_rank_gates(plan, v_top, ranks):
    """A rank sweep pads each rank's factors with zero columns up to the
    top rank: at each of ``ranks`` the kernel's picks from the padded
    factors must equal the truncated factors' picks, ids and values bit
    for bit (the plan's first chunk)."""
    import torch
    from polara_tpu_torch.evaluation.pipelines import _mask_trailing_columns
    from polara_tpu_torch.models import SVDModel
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    chunk = plan.chunks[0]
    n_items, top = v_top.shape
    bits = plan.seen_bits(0, n_items)
    for r in ranks:
        v_pad = _mask_trailing_columns(v_top, r).contiguous()
        params = {"item_factors": v_pad, "item_panel": v_pad}
        proj = SVDModel.proj_chunk(params, chunk).contiguous()
        pad_vals, pad_ids = fused_score_topk(proj, v_pad, bits, TOPK,
                                             n_valid_cols=n_items,
                                             return_values=True)
        tr_vals, tr_ids = fused_score_topk(
            proj[:, :r].contiguous(), v_pad[:, :r].contiguous(), bits,
            TOPK, n_valid_cols=n_items, return_values=True)
        check(torch.equal(pad_ids, tr_ids) and torch.equal(pad_vals,
                                                           tr_vals),
              f"rank {r}: padded-to-{top} picks == truncated picks, ids and "
              "values bit for bit")


def sweep_kernel_fields(proj, panel, bits, n_items, reps=20):
    """The kernel at the sweep's top-rank shape: its time beside the plain
    version's, cuBLAS's scores alone and the PyTorch route (scores, seen
    mask, ``torch.topk``, as phase 3's ``topk_baseline``), its bound, and
    the item split (:func:`split_fields`: the split count, the blocks per
    SM the occupancy query reports, the time with one split)."""
    import torch
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference,
                                                 seen_mask)
    n_users, rank = proj.shape
    fields = {"users": n_users, "items": n_items, "rank": rank}
    if proj.is_cuda:
        fields["ms"] = time_ms(lambda: fused_score_topk(
            proj, panel, bits, TOPK, n_valid_cols=n_items), reps)
        fields["plain_ms"] = time_ms(lambda: fused_score_topk_reference(
            proj, panel, bits, TOPK, n_valid_cols=n_items), 3)
        fields["library_ms"] = time_ms(lambda: proj @ panel.T, reps)

        def topk_route():
            s = proj @ panel.T
            s.masked_fill_(seen_mask(bits, n_items), -torch.inf)
            return torch.topk(s, TOPK, dim=1)
        fields["topk_ms"] = time_ms(topk_route, reps)
        fields.update(split_fields(proj, panel, bits, n_items, reps=reps))
    fields["flop"] = 2 * n_users * n_items * rank
    fields["bytes"] = 4 * (proj.numel() + n_items * rank
                           + n_users * -(-n_items // 32) + 2 * n_users * TOPK)
    return fields


# --------------------------------------------------------------------------
# phase 6: the mesh path
# --------------------------------------------------------------------------

def mesh_devices(n_entries: int, device="cuda"):
    """``n_entries`` mesh entries dealt to the visible cards in turn (on a
    one-card machine every entry is that card); off the card, ``device``."""
    import torch
    if torch.device(device).type != "cuda":
        return [torch.device(device)] * n_entries
    n_cards = torch.cuda.device_count()
    return [torch.device("cuda", i % n_cards) for i in range(n_entries)]


def _bits_words(bits, lo_col: int, hi_col: int):
    return bits[:, lo_col // 32:-(-hi_col // 32)].contiguous()


def mesh_shard_fields(proj, panel, bits, n_valid, device):
    """The kernel at one mesh shard's inputs, held against its plain
    version as in phases 2 and 3 (:func:`_compare`: PAD slots, ids in
    range and unseen, no repeats, each pick's re-scored gap within
    ``RESCORE_RTOL``) and its values within ``RESCORE_RTOL`` of the
    largest plain score; then its time beside the plain version's and
    cuBLAS's scores alone, and its least work (as
    :func:`sweep_kernel_fields`)."""
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference)
    n_users, rank = proj.shape
    agree, err = _compare(proj, panel, bits, TOPK, n_valid=n_valid)
    pv, _ = fused_score_topk_reference(proj, panel, bits, TOPK,
                                       n_valid_cols=n_valid,
                                       return_values=True)
    scale = pv[pv > -np.inf].abs().max().item()
    check(err <= RESCORE_RTOL * scale, f"shard {n_users} x {n_valid}: max "
          f"|value diff| {err:.2e} <= {RESCORE_RTOL:g} x the largest plain "
          f"score {scale:.3e}")
    fields = {"users": n_users, "items": n_valid, "rank": rank,
              "max_abs_err": err, "exact_agreement": agree}
    if proj.is_cuda:
        # 50 calls: at ~1 ms a call, 20 read up to 5% apart between runs
        fields["ms"] = time_ms(lambda: fused_score_topk(
            proj, panel, bits, TOPK, n_valid_cols=n_valid), 50)
        fields["plain_ms"] = time_ms(lambda: fused_score_topk_reference(
            proj, panel, bits, TOPK, n_valid_cols=n_valid), 3)
        fields["library_ms"] = time_ms(lambda: proj @ panel.T, 20)
        fields["topk_ms"] = time_ms(lambda: topk_route(proj, panel, bits,
                                                       n_valid), 20)
        fields.update(split_fields(proj, panel, bits, n_valid, reps=50))
    fields["flop"] = 2 * n_users * n_valid * rank
    fields["bytes"] = 4 * (proj.numel() + n_valid * rank
                           + n_users * -(-n_valid // 32) + 2 * n_users * TOPK)
    return fields


def topk_route(proj, panel, bits, n_valid, k=TOPK):
    """The library route to the kernel's function: cuBLAS scores, the seen
    mask, ``torch.topk`` (no tie order promised)."""
    import torch
    from polara_tpu_torch.ops.fused_topk import seen_mask
    s = proj @ panel[:n_valid].T
    s.masked_fill_(seen_mask(bits, n_valid), -torch.inf)
    return torch.topk(s, k, dim=1)


def k_fields(proj, panel, bits, n_valid, k, reps=5):
    """The kernel at these inputs with a k-slot list: phase 2's gates
    against its plain version (:func:`_compare`), its time beside the
    plain version's, cuBLAS's scores alone and the ``torch.topk`` route,
    the item split (:func:`split_fields`) and its least work."""
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference)
    n_users, rank = proj.shape
    agree, err = _compare(proj, panel, bits, k, n_valid=n_valid)
    fields = {"users": n_users, "items": n_valid, "rank": rank, "k": k,
              "max_abs_err": err, "exact_agreement": agree}
    if proj.is_cuda:
        fields["ms"] = time_ms(lambda: fused_score_topk(
            proj, panel, bits, k, n_valid_cols=n_valid), reps)
        fields["plain_ms"] = time_ms(lambda: fused_score_topk_reference(
            proj, panel, bits, k, n_valid_cols=n_valid), 2)
        fields["library_ms"] = time_ms(lambda: proj @ panel[:n_valid].T,
                                       reps)
        fields["topk_ms"] = time_ms(lambda: topk_route(
            proj, panel, bits, n_valid, k), reps)
        fields.update(split_fields(proj, panel, bits, n_valid, k, reps))
    fields["flop"] = 2 * n_users * n_valid * rank
    fields["bytes"] = 4 * (proj.numel() + n_valid * rank
                           + n_users * -(-n_valid // 32) + 2 * n_users * k)
    return fields


def mesh_phase(geometry, device="cuda"):
    """Phase 6: PureSVD rank 50 at this geometry (phase 3's data and seed)
    over a (4, 1) ``users`` mesh and a (2, 2) ``users x model`` mesh whose
    entries go to the visible cards in turn.  Returns the measured fields;
    raises on a failed gate except the launch counts of the counted
    scoring runs (``launches``), which the caller checks."""
    import torch
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.models.svd import SVDModel
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.ops.rsvd import (cholesky_qr2,
                                           principal_angles_max_sin,
                                           randomized_svd)
    from polara_tpu_torch.ops.scoring import (ChunkedTestData,
                                              _merge_candidates, run_scoring,
                                              run_scoring_fused)
    from polara_tpu_torch.ops.sparse import (CooMatrix, dense_operator,
                                             dense_power_operator)
    from polara_tpu_torch.parallel import (full_train_step,
                                           score_mask_topk_step)
    from polara_tpu_torch.runtime.mesh import (ShardedRows, make_mesh,
                                               pad_to_multiple,
                                               shard_device_count, shard_rows)

    n_users, n_items = geometry["n_users"], geometry["n_items"]
    out = {}
    meshes = {name: make_mesh(devices=mesh_devices(r * c, device),
                              shape=(r, c))
              for name, (r, c) in (("mesh_1d", (4, 1)), ("mesh_2d", (2, 2)))}
    for name, mesh in meshes.items():
        grid = np.vectorize(str, otypes=[object])(mesh.devices).tolist()
        log(f"  {name} {mesh.shape}: device grid {grid}")
        out[f"{name}_grid"] = grid
    n_dev = {name: mesh.shape["users"] for name, mesh in meshes.items()}
    n_model = {name: mesh.shape["model"] for name, mesh in meshes.items()}

    # ---- phase 3's data, split and staging
    rows_d, cols_d, vals_d = make_realistic_coo_device(**geometry, seed=0,
                                                       device=device)
    rows, cols, vals = (x.cpu().numpy() for x in (rows_d, cols_d, vals_d))
    _, hold_items, hold_mask = holdout_split(rows, cols)
    keep = ~hold_mask
    matrix = CooMatrix.from_numpy(rows[keep], cols[keep], vals[keep],
                                  (n_users, n_items), device=device)
    dense = matrix.to_dense()
    hold_items_d = torch.as_tensor(hold_items, device=device)
    # one plan per users-axis size (1, 4, 2): chunks align to the axis and
    # their budget scales by the distinct cards holding its shards
    shard_devices = {1: 1, **{n_dev[name]: shard_device_count(mesh)
                              for name, mesh in meshes.items()}}
    plans = {n: ChunkedTestData.build(rows[keep], cols[keep], vals[keep],
                                      n_users=n_users, n_items=n_items,
                                      device=device, n_shards=n,
                                      n_devices=n_devices)
             for n, n_devices in shard_devices.items()}
    plan = plans[1]

    # ---- the build: dense block and bf16 copy sharded over the 1-D mesh,
    # CholeskyQR2 panels; single-device Householder build beside it
    def build(mesh):
        a = dense if mesh is None else shard_rows(dense, mesh)
        return randomized_svd(dense_operator(a), RANK, n_iter=POWER_ITERS,
                              tol=None, seed=0,
                              qr_method=None if mesh is None else "cholesky2",
                              power_operator=dense_power_operator(a))

    mesh1 = meshes["mesh_1d"]
    with Timer() as t:
        result = build(mesh1)
    out["mesh_build_s"] = t.seconds
    with Timer() as t:
        build(mesh1)
    out["mesh_build_warm_s"] = t.seconds
    with Timer() as t:
        single = build(None)
    out["single_build_warm_s"] = t.seconds
    check(tuple(result.u.shape) == (n_users, RANK),
          "mesh build: u gathered without the padding rows")
    resid = dense @ result.v - result.u * result.s[None, :]
    out["triplet_residual"] = (torch.linalg.norm(resid, dim=0)
                               / result.s[0]).max().item()
    del resid
    check(out["triplet_residual"] < 1e-2, f"mesh build: max triplet "
          f"residual {out['triplet_residual']:.3e} < 1e-2")
    out["max_sin_vs_single"] = principal_angles_max_sin(result.v.double(),
                                                        single.v.double())
    log(f"  mesh build {out['mesh_build_s']:.3f} s cold, "
        f"{out['mesh_build_warm_s']:.3f} s warm; single-device "
        f"{out['single_build_warm_s']:.3f} s; largest principal-angle sine "
        f"vs the single-device build {out['max_sin_vs_single']:.3e}")

    # ---- the counted drive: the mesh build's factors scored on each mesh
    v = result.v.contiguous()
    params = {"item_factors": v, "item_panel": v}
    recs = {}
    for name, mesh in meshes.items():
        fused_score_topk.launches = 0
        recs[name] = run_scoring_fused(
            plans[n_dev[name]], SVDModel.proj_chunk, params, TOPK,
            n_valid_cols=n_items, on_device=True, item_order="popularity",
            mesh=mesh)
        out.setdefault("launches", {})[name] = fused_score_topk.launches
        out.setdefault("expected_launches", {})[name] = (
            n_dev[name] * n_model[name] * len(plans[n_dev[name]].chunks))
        check(tuple(recs[name].shape) == (n_users, TOPK)
              and bool(((recs[name] >= 0) & (recs[name] < n_items)).all()),
              f"{name}: recommendation shape, every id in [0, {n_items})")
    # two projections: index_add_ may differ in the last bit between them
    out["mesh_1d_vs_2d_agreement"] = (
        recs["mesh_1d"] == recs["mesh_2d"]).float().mean().item()
    hr, ndcg = _hit_metrics(recs["mesh_1d"], hold_items_d)
    out.update(hr10=hr, ndcg10=ndcg)

    # quality bars of phase 3, against exact f64 factors
    d64 = dense.double()
    evals, evecs = torch.linalg.eigh(d64.T @ d64)
    del d64
    v_ex = evecs[:, -RANK:].flip(1).float().contiguous()
    recs_ex = run_scoring_fused(plan, SVDModel.proj_chunk,
                                {"item_factors": v_ex, "item_panel": v_ex},
                                TOPK, n_valid_cols=n_items, on_device=True,
                                item_order="popularity")
    hr_ex, ndcg_ex = _hit_metrics(recs_ex, hold_items_d)
    out["metric_delta_vs_exact"] = max(abs(hr - hr_ex), abs(ndcg - ndcg_ex))
    out["top10_overlap"] = ((recs["mesh_1d"][:, :, None]
                             == recs_ex[:, None, :]).sum((1, 2)).double()
                            / TOPK).mean().item()
    log(f"  mesh HR@{TOPK} {hr:.5f} NDCG@{TOPK} {ndcg:.5f}; exact "
        f"factors HR@{TOPK} {hr_ex:.5f} NDCG@{TOPK} {ndcg_ex:.5f}")
    check(out["metric_delta_vs_exact"] < 1e-3, f"mesh build: "
          f"metric_delta_vs_exact {out['metric_delta_vs_exact']:.2e} < 1e-3")
    check(out["top10_overlap"] >= 0.99, f"mesh build: top-{TOPK} overlap "
          f"{out['top10_overlap']:.5f} >= 0.99")

    # ---- mesh picks == single-device picks on one projection
    proj_all = torch.cat([SVDModel.proj_chunk(params, c)
                          for c in plan.chunks])[:n_users].contiguous()
    fixed = {"item_panel": v, "proj": proj_all}

    def fixed_proj(p, chunk):
        return p["proj"][chunk.users]

    def route(name, filter_seen, proj_fn=fixed_proj, p=fixed):
        mesh = meshes.get(name)
        return run_scoring_fused(
            plans[n_dev.get(name, 1)], proj_fn, p, TOPK,
            filter_seen=filter_seen, n_valid_cols=n_items, on_device=True,
            item_order="popularity", mesh=mesh, return_values=True)

    for filter_seen in (True, False):
        want_vals, want_ids = route(None, filter_seen)
        for name in meshes:
            before = fused_score_topk.launches
            got_vals, got_ids = route(name, filter_seen)
            launched = fused_score_topk.launches - before
            check(torch.equal(got_ids, want_ids)
                  and torch.equal(got_vals, want_vals),
                  f"{name} filter_seen={filter_seen}: ids and values == "
                  f"the single-device kernel's on one projection")
            if proj_all.is_cuda:
                check(launched == out["expected_launches"][name],
                      f"{name}: {launched} launches == user shards x item "
                      f"shards x chunks")

    # ---- the unfused route (run_scoring) per users shard == one device, on
    # one fixed score block of the first users
    few = min(n_users, VERIFY_USERS)
    sub = rows[keep] < few
    few_plans = {n: ChunkedTestData.build(
        rows[keep][sub], cols[keep][sub], vals[keep][sub], n_users=few,
        n_items=n_items, device=device, n_shards=n, n_devices=n_devices)
        for n, n_devices in shard_devices.items()}
    block = {"scores": proj_all[:few] @ v.T}
    want = run_scoring(few_plans[1], lambda p, chunk: p["scores"][
        chunk.users], block, TOPK, n_valid_cols=n_items, on_device=True)
    for name, mesh in meshes.items():
        got = run_scoring(few_plans[n_dev[name]], lambda p, chunk: p[
            "scores"][chunk.users], block, TOPK, n_valid_cols=n_items,
            on_device=True, mesh=mesh)
        check(torch.equal(got, want), f"{name}: run_scoring per users shard "
              f"== one device on a fixed {few} x {n_items} score block")
    del block, few_plans

    # ---- times: the scoring routes, one shard's kernel, the merge,
    # CholeskyQR2 at the build's panel shape
    if proj_all.is_cuda:
        out["scoring_ms"] = {name: time_ms(lambda name=name: route(
            name, True, SVDModel.proj_chunk, params), 5)
            for name in ("single", *meshes)}
        log("  scoring ms (proj_chunk + kernel + merge): " + ", ".join(
            f"{k} {t:.3f}" for k, t in out["scoring_ms"].items()))
    perm, inv = plan.pop_order(n_items)
    panel = v.index_select(0, torch.as_tensor(perm, device=v.device))
    shards = {}
    for name in meshes:
        per = -(-n_users // n_dev[name])
        width = (n_items if n_model[name] == 1
                 else pad_to_multiple(-(-n_items // n_model[name]), 32))
        bits = plans[n_dev[name]].seen_bits(0, n_model[name] * width,
                                            col_map=inv,
                                            map_token=("pop", n_items))
        n_valid = min(width, n_items)
        shards[name] = mesh_shard_fields(
            proj_all[:per].contiguous(), panel[:n_valid].contiguous(),
            _bits_words(bits[:per], 0, n_valid), n_valid, device)
        log(f"  {name} shard {per} x {n_valid} x {RANK}: " + json.dumps(
            shards[name]))
    out["shards"] = shards
    half = -(-n_users // 2)
    cand = [fused_score_topk(proj_all[:half].contiguous(), panel[lo:hi],
                             torch.zeros((half, -(-(hi - lo) // 32)),
                                         dtype=torch.int32, device=device),
                             TOPK, return_values=True)
            for lo, hi in ((0, n_items // 2), (n_items // 2, n_items))]
    if proj_all.is_cuda:
        out["merge_ms"] = time_ms(lambda: _merge_candidates(
            [c[0] for c in cand], [c[1] for c in cand], TOPK,
            proj_all.device), 20)
        gen = torch.Generator(device=device).manual_seed(0)
        tall = torch.randn((n_users, RANK + max(10, RANK)), generator=gen,
                           device=device)
        out["cholesky_qr2_ms"] = time_ms(lambda: cholesky_qr2(tall), 10)
        tall_sharded = shard_rows(tall, mesh1)
        out["cholesky_qr2_sharded_ms"] = time_ms(
            lambda: cholesky_qr2(tall_sharded), 10)
        out["householder_qr_ms"] = time_ms(lambda: torch.linalg.qr(tall), 10)
        log(f"  merge {out['merge_ms']:.3f} ms; at {tuple(tall.shape)}: "
            f"CholeskyQR2 {out['cholesky_qr2_ms']:.3f} ms, over 4 row "
            f"shards {out['cholesky_qr2_sharded_ms']:.3f} ms, Householder "
            f"QR {out['householder_qr_ms']:.3f} ms")
    del cand

    # ---- full_train_step on the 1-D mesh: factorize -> score -> hits
    gen = torch.Generator(device=device).manual_seed(0)
    omega = torch.randn((n_items, RANK + max(10, RANK)), generator=gen,
                        device=device)
    seen = (torch.as_tensor(rows[keep], device=device),
            torch.as_tensor(cols[keep], device=device),
            torch.ones(int(keep.sum()), dtype=torch.bool, device=device))
    r_sharded = shard_rows(dense, mesh1)
    # the row blocks' products against the whole block's, bit for bit
    # (cuBLAS may pick another algorithm for fewer rows)
    out["shard_proj_bitwise_equal"] = torch.equal(
        r_sharded.blocks[0] @ v, (dense @ v)[:r_sharded.blocks[0].shape[0]])
    with Timer() as t:
        step = full_train_step(r_sharded, omega, r_sharded, *seen,
                               hold_items_d, n_iter=POWER_ITERS, k=RANK,
                               topk=TOPK)
        step_hits = int(step.hit_count)
    out["full_train_step_s"] = t.seconds
    del r_sharded
    single_recs = score_mask_topk_step(step.factors.v, dense, *seen, TOPK)
    single_hits = int((single_recs == hold_items_d[:, None]).any(1).sum())
    out.update(full_train_step_hits=step_hits,
               single_device_hits=single_hits,
               full_train_step_recs_agreement=(
                   step.recommendations == single_recs).float().mean().item())
    check(step_hits == single_hits, f"full_train_step hit count {step_hits} "
          f"== its factors scored on one device ({single_hits})")
    del single_recs, step

    # ---- the models' mesh route through the data model: SVDModel with
    # mesh= (2-D), against the same model on one device
    data = RecommenderData(events_frame(rows_d, cols_d, vals_d), "userid",
                           "movieid", "rating", seed=0, verbose=False)
    data.warm_start = False
    data.test_ratio = 0.05
    data.holdout_size = 1
    data.prepare()
    models = {}
    for name, mesh in (("single", None), ("mesh_2d", meshes["mesh_2d"])):
        model = SVDModel(data, device=device, mesh=mesh)
        model.verbose = False
        model.rank = RANK
        model.svd_tol = None
        model.svd_iters = POWER_ITERS
        model.svd_power_dtype = torch.bfloat16
        before = fused_score_topk.launches
        out.setdefault("model_hr10", {})[name] = model.evaluate(
            "relevance").hr
        out.setdefault("model_launches", {})[name] = (
            fused_score_topk.launches - before)
        out.setdefault("model_build_s", {})[name] = model.training_time[-1]
        models[name] = model
    dist = models["mesh_2d"]
    check(isinstance(data._device_matrix_cache[dist._last_dense_key],
                     ShardedRows),
          "SVDModel(mesh=): the dense block is cached row-sharded")
    if proj_all.is_cuda:
        expected = 4 * len(dist._test_plan.chunks)
        check(out["model_launches"]["mesh_2d"] == expected,
              f"SVDModel(mesh=): {out['model_launches']['mesh_2d']} "
              f"launches == 2 x 2 shards x chunks ({expected})")
    out["model_max_sin"] = principal_angles_max_sin(
        dist.factors["movieid"].double(),
        models["single"].factors["movieid"].double())
    check(abs(out["model_hr10"]["mesh_2d"] - out["model_hr10"]["single"])
          <= 1e-3, f"SVDModel(mesh=) HR@10 {out['model_hr10']['mesh_2d']:.5f}"
          f" within 1e-3 of one device's {out['model_hr10']['single']:.5f}")
    a, b = dist.recommendations, models["single"].recommendations
    out["model_top10_overlap"] = float(
        (a[:, :, None] == b[:, None, :]).sum((1, 2)).mean() / a.shape[1])
    check(out["model_top10_overlap"] >= 0.99, f"SVDModel(mesh=) top-10 "
          f"overlap with one device's {out['model_top10_overlap']:.5f} "
          ">= 0.99")
    log(f"  SVDModel mesh_2d vs single: HR@10 {json.dumps(out['model_hr10'])}"
        f", builds {json.dumps(out['model_build_s'])} s, principal-angle "
        f"sine {out['model_max_sin']:.3e}")
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if proj_all.is_cuda else None)
    return out


# --------------------------------------------------------------------------
# phase 7: the factor models
# --------------------------------------------------------------------------

IALS = dict(alpha=1.0, weight="log2", epsilon=1.0, reg=0.01)
IALS_EPOCHS, BPR_EPOCHS, BPR_LR, BPR_BATCH = 15, 10, 0.05, 4096


def _rank_metrics(recs, hold_items):
    """HR@k, MRR@k and NDCG@k of one held-out item per user."""
    import torch
    from polara_tpu_torch.evaluation.metrics import metrics_core
    n = recs.shape[0]
    ones = torch.ones((n, 1), dtype=torch.bool, device=recs.device)
    out = metrics_core(recs, hold_items[:, None],
                       torch.ones((n, 1), dtype=torch.float64,
                                  device=recs.device), ones, ones,
                       topk=recs.shape[1], switch_positive=0.0,
                       alternative=True, has_split=False, penalty=0.0)
    return {name: out[name].item() for name in ("hr", "mrr", "ndcg")}


def _fused_gap(plan, user, item, recs, n_items, verify_users=VERIFY_USERS):
    """Phase 3's ``fused_ok`` measure on a factor model: the kernel's picks
    for the first users against the plain version's, re-scored in f64,
    relative to the slice's largest plain score."""
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk_reference,
                                                 pack_seen_bits)
    head = plan.chunks[0]
    proj = user[:verify_users].contiguous()
    sel = head.valid & (head.rows < proj.shape[0])
    bits = pack_seen_bits(head.rows[sel], head.cols[sel], proj.shape[0],
                          n_items)
    plain = fused_score_topk_reference(proj, item, bits, TOPK)
    s64 = proj.double() @ item.double().T
    s_plain = s64.gather(1, plain.long())
    s_kern = s64.gather(1, recs[:proj.shape[0]].long())
    scale = max(s_plain.abs().max().item(), 1e-6)
    return (s_plain - s_kern).abs().max().item() / scale


def _known_user_gap(model):
    """``_fused_gap`` of a known-user factor model (PMF's factor lookup):
    its test users' rows of the user factors against its item panel."""
    import torch
    params = model.score_params()
    check(model.uses_fused_scoring(params),
          f"{model.method} routes to the kernel over its item factors")
    panel = params["item_panel"]
    users = torch.as_tensor(model._test_users, device=panel.device)
    proj = model.factors[model.data.fields.userid].index_select(0, users)
    return _fused_gap(model._test_plan, proj, panel,
                      model._device_recommendations(), panel.shape[0])


def _overlap(a, b):
    """Mean share of each row's ids that the other row also holds."""
    return ((a[:, :, None] == b[:, None, :]).sum((1, 2)).double()
            / a.shape[1]).mean().item()


def ials_split_ms(dense, item, batch_rows, reps=5):
    """One iALS user half-sweep at these inputs (CUDA events), and its three
    parts each timed alone on one batch of ``batch_rows`` users and scaled
    by the batch count: the confidence transform, the weighted Gram
    product, and the batched Cholesky factorization plus solve."""
    import torch
    from polara_tpu_torch.ops import implicit as imp
    n_users = dense.shape[0]
    n_batches = -(-n_users // batch_rows)
    blk = dense[:batch_rows]
    cm1 = imp.confidence(blk, IALS["alpha"], IALS["weight"],
                         IALS["epsilon"]).contiguous()
    gram = imp._gram(item, IALS["reg"])
    a = gram[None] + torch.matmul((cm1[:, :, None] * item[None]).transpose(
        1, 2), item)
    rhs = torch.where(cm1 > 0, cm1 + 1.0, 0.0) @ item
    failures = []

    def weighted_gram():
        return torch.matmul((cm1[:, :, None] * item[None]).transpose(1, 2),
                            item)

    parts = {
        "confidence": lambda: imp.confidence(blk, IALS["alpha"],
                                             IALS["weight"],
                                             IALS["epsilon"]).contiguous(),
        "weighted_gram": weighted_gram,
        "cholesky_solve": lambda: imp._cholesky_solve(a, rhs, failures),
    }
    out = {name: time_ms(fn, reps) * n_batches for name, fn in parts.items()}
    out["user_half_sweep"] = time_ms(lambda: imp._ials_sweep(
        dense, item, IALS["alpha"], IALS["epsilon"], IALS["reg"],
        IALS["weight"], batch_rows, axis=0), 2)
    out["batch_rows"], out["n_batches"] = batch_rows, n_batches
    imp._raise_if_failed(failures)
    return out


def factor_phase(geometry, warm_geometry, device="cuda", trained=None):
    """Phase 7: iALS (dense and event tiers), BPR, PMF and popularity on
    phase 3's data and split, scored through the fused kernel; the mesh
    trainers and scorings on one card; iALS warm start through the data
    model at ``warm_geometry``.  Returns the measured fields; raises on a
    failed gate except the launch counts (``launches``), which the caller
    checks.  The iALS and BPR item factors go to ``trained["ials"]`` and
    ``trained["bpr"]`` when a dict is given (phase 9 serves them)."""
    import torch
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.models import (ImplicitALS, PopularityModel,
                                         ProbabilisticMF)
    from polara_tpu_torch.ops import implicit as imp
    from polara_tpu_torch.ops.factorize import mf_train
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.ops.scoring import (ChunkedTestData,
                                              run_scoring_fused)
    from polara_tpu_torch.ops.sparse import CooMatrix
    from polara_tpu_torch.parallel import distributed_bpr, distributed_ials
    from polara_tpu_torch.runtime.mesh import make_mesh

    t_phase = wall()
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    n_users, n_items = geometry["n_users"], geometry["n_items"]
    out = {"epoch_s": {}, "metrics": {}, "launches": {}, "fused_gap": {}}

    # ---- phase 3's data and split; every user is a test user
    rows_d, cols_d, vals_d = make_realistic_coo_device(**geometry, seed=0,
                                                       device=device)
    rows, cols, vals = (x.cpu().numpy() for x in (rows_d, cols_d, vals_d))
    del rows_d, cols_d, vals_d
    _, hold_items, hold_mask = holdout_split(rows, cols)
    keep = ~hold_mask
    train = [torch.as_tensor(x[keep], device=device)
             for x in (rows, cols, vals.astype(np.float32))]
    shape = (n_users, n_items)
    dense = CooMatrix.from_numpy(rows[keep], cols[keep], vals[keep], shape,
                                 device=device).to_dense()
    plan = ChunkedTestData.build(rows[keep], cols[keep], vals[keep],
                                 n_users=n_users, n_items=n_items,
                                 device=device)
    hold_d = torch.as_tensor(hold_items, device=device)
    test_users = torch.arange(n_users, device=device)

    def score(name, user, item, mesh=None):
        """The known-user route of the factor models (PMF's factor
        lookup, which iALS and BPR share; the fused kernel over the
        popularity-ordered panel), counted."""
        params = {"user_factors": user, "item_factors": item,
                  "item_panel": item, "test_users": test_users}
        before = fused_score_topk.launches
        vals_, recs = run_scoring_fused(
            plan, ProbabilisticMF.proj_chunk, params, TOPK,
            n_valid_cols=n_items, on_device=True, item_order="popularity",
            mesh=mesh, return_values=True)
        out["launches"][name] = fused_score_topk.launches - before
        return vals_, recs

    def evaluate(name, user, item):
        _, recs = score(name, user, item)
        out["metrics"][name] = _rank_metrics(recs, hold_d)
        log(f"  {name}: HR@{TOPK} {out['metrics'][name]['hr']:.5f} "
            f"MRR@{TOPK} {out['metrics'][name]['mrr']:.5f} NDCG@{TOPK} "
            f"{out['metrics'][name]['ndcg']:.5f}; "
            f"{out['launches'][name]} launch(es)")
        return recs

    # ---- popularity: training counts as a rank-1 factor model
    counts = torch.bincount(train[1], minlength=n_items).float()
    evaluate("popularity", torch.ones((n_users, 1), device=device),
             counts[:, None].contiguous())

    # ---- iALS, dense tier
    with Timer() as t:
        ials = imp.ials_train(dense, RANK, num_epochs=IALS_EPOCHS, seed=0,
                              **IALS)
    out["ials_dense_s"] = t.seconds
    out["epoch_s"]["ials_dense"] = t.seconds / IALS_EPOCHS
    recs_dense = evaluate("ials_dense", ials.user, ials.item)
    out["fused_gap"]["ials"] = _fused_gap(plan, ials.user, ials.item,
                                          recs_dense, n_items)

    # ---- iALS, event tier (the same start: the same seed's draw)
    with Timer() as t:
        imp.ials_train_events(*train, shape, RANK, num_epochs=0, seed=0,
                              **IALS)
    out["ials_events_staging_s"] = t.seconds
    with Timer() as t:
        events = imp.ials_train_events(*train, shape, RANK,
                                       num_epochs=IALS_EPOCHS, seed=0, **IALS)
    out["ials_events_s"] = t.seconds
    out["epoch_s"]["ials_events"] = ((t.seconds - out["ials_events_staging_s"])
                                     / IALS_EPOCHS)
    recs_events = evaluate("ials_events", events.user, events.item)
    out["ials_tier_overlap"] = _overlap(recs_events, recs_dense)
    out["ials_tier_hr_delta"] = abs(out["metrics"]["ials_events"]["hr"]
                                    - out["metrics"]["ials_dense"]["hr"])
    out["ials_tier_item_rel_diff"] = (
        torch.linalg.norm(events.item - ials.item)
        / torch.linalg.norm(ials.item)).item()
    del events

    # ---- where an iALS half-sweep spends its time
    batch_user = imp._auto_batch_rows(n_users, n_items, RANK)
    out["ials_split_ms"] = (ials_split_ms(dense, ials.item, batch_user)
                            if dense.is_cuda else None)
    log(f"  iALS split (ms per user half-sweep): "
        f"{json.dumps(out['ials_split_ms'])}")

    # ---- BPR
    aucs = []
    with Timer() as t:
        bpr = imp.bpr_train(train[0], train[1], shape, RANK,
                            learning_rate=BPR_LR, reg=IALS["reg"],
                            num_epochs=BPR_EPOCHS, batch_size=BPR_BATCH,
                            seed=0, epoch_stats=aucs)
    out["bpr_s"] = t.seconds
    out["epoch_s"]["bpr"] = t.seconds / BPR_EPOCHS
    n_steps = -(-len(train[0]) // BPR_BATCH)
    out["bpr_pairs_per_s"] = BPR_EPOCHS * n_steps * BPR_BATCH / t.seconds
    out["bpr_auc"] = aucs
    recs_bpr = evaluate("bpr", bpr.user, bpr.item)
    out["fused_gap"]["bpr"] = _fused_gap(plan, bpr.user, bpr.item, recs_bpr,
                                         n_items)

    # ---- PMF, its defaults, on the ratings
    rmse, epoch_times = [], []
    with Timer() as t:
        pmf = mf_train(*train, shape, 10, lrate=0.005, lambd=0.5,
                       num_epochs=25, tol=1e-4, batch_size=8192,
                       optimizer="sgd", generalized=True, seed=0,
                       iter_errors=rmse, iter_time=epoch_times)
    out["pmf_s"] = t.seconds
    out["epoch_s"]["pmf"] = float(np.mean(epoch_times))
    out["pmf_rmse"] = rmse
    evaluate("pmf", pmf.p, pmf.q)
    del pmf

    log(f"  seconds per epoch: {json.dumps(out['epoch_s'])}; iALS event "
        f"staging {out['ials_events_staging_s']:.3f} s; BPR "
        f"{out['bpr_pairs_per_s']:.4g} sampled pairs/s")

    # ---- gates
    for name in ("ials", "bpr"):
        check(out["fused_gap"][name] < 1e-3, f"{name} fused_ok: re-scored "
              f"gap {out['fused_gap'][name]:.2e} < 1e-3")
    pop_hr = out["metrics"]["popularity"]["hr"]
    for name in ("ials_dense", "bpr"):
        check(out["metrics"][name]["hr"] > pop_hr,
              f"{name} HR@{TOPK} {out['metrics'][name]['hr']:.5f} > "
              f"popularity's {pop_hr:.5f}")
    check(aucs[-1] > aucs[0] and aucs[-1] > 0.85,
          f"BPR batch AUC {aucs[0]:.4f} -> {aucs[-1]:.4f}: rises, ends > 0.85")
    check(all(np.isfinite(rmse)) and all(
        b <= a for a, b in zip(rmse[:5], rmse[1:5])),
        f"PMF RMSE finite, non-increasing over the first 5 epochs "
        f"({', '.join(f'{r:.5f}' for r in rmse[:5])})")
    check(out["ials_tier_overlap"] >= 0.99
          and out["ials_tier_hr_delta"] <= 1e-3,
          f"iALS event tier vs dense tier: top-{TOPK} overlap "
          f"{out['ials_tier_overlap']:.5f} >= 0.99, |dHR@{TOPK}| "
          f"{out['ials_tier_hr_delta']:.2e} <= 1e-3")

    # ---- the mesh trainers and scorings, every entry on this card
    mesh41 = make_mesh(devices=mesh_devices(4, device), shape=(4, 1))
    mesh22 = make_mesh(devices=mesh_devices(4, device), shape=(2, 2))
    with Timer() as t:
        dist = distributed_ials(dense, RANK, mesh41, num_epochs=2, seed=0,
                                batch_rows=None, **IALS)
    out["distributed_ials_s"] = t.seconds
    start = imp._initial_item_factors(n_items, RANK, 0, torch.float32,
                                      dense.device)
    with Timer() as t:
        _, item2 = imp._ials_epochs(
            dense, torch.zeros((n_users, RANK), device=dense.device), start,
            IALS["alpha"], IALS["epsilon"], IALS["reg"], IALS["weight"], 2,
            batch_user, imp._auto_batch_rows(n_items, n_users, RANK))
    out["ials_two_epochs_s"] = t.seconds
    out["distributed_ials_rel_diff"] = (torch.linalg.norm(dist.item - item2)
                                        / torch.linalg.norm(item2)).item()
    check(out["distributed_ials_rel_diff"] <= 1e-4,
          f"distributed_ials (4, 1) vs _ials_epochs, 2 epochs: relative "
          f"Frobenius difference of the item factors "
          f"{out['distributed_ials_rel_diff']:.2e} <= 1e-4")
    del dist, item2

    want = score("single_fixed", ials.user, ials.item)
    mesh_launches = 0
    for name, mesh in (("mesh_1d", mesh41), ("mesh_2d", mesh22)):
        got = score(name, ials.user, ials.item, mesh=mesh)
        mesh_launches += out["launches"][name]
        check(torch.equal(got[1], want[1]) and torch.equal(got[0], want[0]),
              f"iALS factors scored on {name}: ids and values == one "
              f"device's")
    out["mesh_launches"] = mesh_launches

    kw = dict(learning_rate=BPR_LR, reg=IALS["reg"], num_epochs=2,
              batch_size=BPR_BATCH, seed=0)
    with Timer() as t:
        dist = distributed_bpr(train[0], train[1], shape, RANK, mesh41,
                               update_mode="exact", **kw)
    out["distributed_bpr_s"] = t.seconds
    single = imp.bpr_train(train[0], train[1], shape, RANK, **kw)
    evaluate("bpr_mesh_exact", dist.user, dist.item)
    evaluate("bpr_two_epochs", single.user, single.item)
    del dist, single
    out["distributed_bpr_hr_delta"] = abs(
        out["metrics"]["bpr_mesh_exact"]["hr"]
        - out["metrics"]["bpr_two_epochs"]["hr"])
    check(out["distributed_bpr_hr_delta"] <= 2e-3,
          f"distributed_bpr exact (4, 1) vs bpr_train, 2 epochs: |dHR@{TOPK}|"
          f" {out['distributed_bpr_hr_delta']:.2e} <= 2e-3")
    if trained is not None:
        trained["ials"], trained["bpr"] = ials.item, bpr.item
    del ials, bpr, dense, plan

    # ---- iALS warm start through the data model (fold-in, mask_and_topk)
    frame = events_frame(*make_realistic_coo_device(**warm_geometry, seed=0,
                                                    device=device))
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.test_ratio = 0.2
    data.holdout_size = 1
    data.prepare()
    warm = {}
    for name, model in (("ials", ImplicitALS(data, device=device)),
                        ("popularity", PopularityModel(data, device=device))):
        model.verbose = False
        if name == "ials":
            model.rank = RANK
        before = fused_score_topk.launches
        table = model.evaluate()
        warm[name] = {f: float(getattr(m, f)) for m in table
                      for f in m._fields if getattr(m, f) is not None}
        warm[name]["launches"] = fused_score_topk.launches - before
    out["warm_start"] = warm
    log(f"  warm start at {warm_geometry}: {json.dumps(warm)}")
    check(all(np.isfinite(v) for v in warm["ials"].values()),
          "warm-start iALS: every metric finite")
    check(warm["ials"]["hr"] > warm["popularity"]["hr"],
          f"warm-start iALS HR@{TOPK} {warm['ials']['hr']:.5f} > "
          f"popularity's {warm['popularity']['hr']:.5f}")
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2**30
                           if torch.device(device).type == "cuda" else None)
    out["phase_s"] = wall() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 8: the tensor path
# --------------------------------------------------------------------------

# benchmarks/ml10m_coffee.py's configuration and mlrank grid
MLRANK = (13, 10, 2)
TUCKER_GRID = ((13, 20, 30, 40), (10, 15, 20, 30), (2, 3, 4))


def coffee_data(geometry, device="cuda", warm_start=True):
    """``benchmarks/ml10m_coffee.py``'s scenario on seeded data at this
    geometry: one random held-out event per test user, 20% test users
    (warm start unless ``warm_start=False``), data seed 0."""
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    frame = events_frame(*make_realistic_coo_device(**geometry, seed=0,
                                                    device=device))
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.warm_start = warm_start
    data.holdout_size = 1
    data.test_ratio = 0.2
    data.random_holdout = True
    data.prepare()
    return data


def coffee_model(data, device, mesh=None, **attrs):
    from polara_tpu_torch.models import CoffeeModel
    model = CoffeeModel(data, device=device, mesh=mesh)
    model.verbose = False
    model.mlrank = MLRANK
    model.seed = 0
    for name, value in attrs.items():
        setattr(model, name, value)
    return model


def max_sin(a, b) -> float:
    """Sine of the largest principal angle between two column spans (f64,
    from the projection residual)."""
    import torch
    qa = torch.linalg.qr(a.double())[0]
    qb = torch.linalg.qr(b.double())[0]
    return torch.linalg.matrix_norm(qb - qa @ (qa.T @ qb), ord=2).item()


def hooi_sweep_split_ms(idx, val, shape, factors, reps=5):
    """One HOOI sweep on the event tier at these inputs (CUDA events) and
    its parts, each timed alone: the three segment sums, the two tall QRs
    with their small SVDs and the level SVD, and the small products (the
    unfoldings and the core); plus the staging of the two event orders."""
    import torch
    from polara_tpu_torch.ops import hooi as hm
    u0, u1, u2 = factors
    core_shape = (u0.shape[1], u1.shape[1], u2.shape[1])
    n0, n1, n2 = shape
    with Timer() as t:
        staged = hm.stage_hooi_events(idx, val, shape, u0.dtype, u0.device)
    sums = hm.event_sums(*staged, n2)
    a, b = sums(0, u1), sums(1, u0)
    m0 = torch.einsum("ufa,fs->uas", a, u2).reshape(n0, -1)
    m1 = torch.einsum("ifb,fs->ibs", b, u2).reshape(n1, -1)
    m2 = torch.einsum("ufa,ub->fab", a, u0).reshape(n2, -1)

    def products():
        torch.einsum("ufa,fs->uas", a, u2)
        torch.einsum("ifb,fs->ibs", b, u2)
        torch.einsum("ufa,ub->fab", a, u0)
        return torch.einsum("ua,ufb,fc->abc", u0, a, u2)

    out = {"staging_ms": t.seconds * 1e3}
    if u0.is_cuda:
        out.update(
            segment_sums=time_ms(lambda: (sums(0, u1), sums(1, u0),
                                          sums(0, u1)), reps),
            qr_svd=time_ms(lambda: (
                hm._left_singular_vectors(m0, core_shape[0]),
                hm._left_singular_vectors(m1, core_shape[1]),
                torch.linalg.svd(m2, full_matrices=False)), reps),
            products=time_ms(products, reps),
            sweep=time_ms(lambda: hm._hooi_sweep(sums, u0, u1, u2, shape,
                                                 core_shape), reps))
    return out


def tensor_phase(geometry, small_geometry, device="cuda", trained=None):
    """Phase 8: CoFFee at ``geometry`` through the data model on the event
    tier, scored through the fused kernel; its rank search, the mesh
    trainer and mesh scorings; the dense tier against the event tier at
    ``small_geometry``.  Returns the measured fields; raises on a failed
    gate except the launch counts (``launches``), which the caller
    checks.  The CoFFee serving bundle goes to ``trained["coffee"]`` when
    a dict is given."""
    import torch
    from polara_tpu_torch import config
    from polara_tpu_torch.evaluation import find_optimal_tucker_ranks
    from polara_tpu_torch.models import (CoffeeModel, PopularityModel,
                                         SVDModel)
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.ops.hooi import hooi
    from polara_tpu_torch.parallel import distributed_hooi
    from polara_tpu_torch.runtime.mesh import make_mesh
    from polara_tpu_torch.runtime.serving import ServingBundle

    t_phase = wall()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}}
    t0 = wall()
    data = coffee_data(geometry, device)
    out["prepare_s"] = wall() - t0
    userid, itemid, feedback = data.fields

    # ---- the path as a user drives it: build, evaluate, counted
    fused_score_topk.launches = 0
    model = coffee_model(data, device)
    t0 = wall()
    model.build()
    out["build_s"] = wall() - t0
    t0 = wall()
    scores = model.evaluate(["relevance", "ranking"])
    out["evaluate_s"] = wall() - t0
    out["hr10"], out["mrr10"] = float(scores[0].hr), float(scores[1].mrr)
    with Timer() as t:
        model.get_recommendations()
    out["scoring_warm_ms"] = t.seconds * 1e3
    out["launches"]["tensor"] = fused_score_topk.launches
    recs = model._device_recommendations()

    idx, val, shape = data.to_coo(tensor_mode=True)
    out["tensor_shape"], out["nnz"] = list(shape), int(len(val))
    history = model.growth_history
    out["sweeps"], out["last_growth"] = len(history), history[-1]
    out["build_s_per_sweep"] = out["build_s"] / len(history)
    tensor_bytes = int(np.prod(shape)) * 4
    budget = config.get_default("hbm_score_budget_gb") * 2 ** 30
    cached = ("coffee_tensor", torch.float32, model.device) in \
        data.__dict__.get("_device_matrix_cache", {})
    log(f"  tensor {shape}, {out['nnz']} events ({tensor_bytes / 2**30:.1f} "
        f"GiB dense); build {out['build_s']:.3f} s, {len(history)} sweeps, "
        f"last growth {history[-1]:.3e} (tolerance {model.growth_tol:g}); "
        f"HR@{TOPK} {out['hr10']:.5f} MRR@{TOPK} {out['mrr10']:.5f}; "
        f"{out['launches']['tensor']} launch(es)")
    check(tensor_bytes > budget and not cached,
          "the build took the event tier (the dense tensor is past "
          "hbm_score_budget_gb, none cached)")
    if history[-1] >= model.growth_tol:
        log(f"  growth did not fall below {model.growth_tol:g} in "
            f"{len(history)} sweeps (last {history[-1]:.3e})")

    # ---- gates of the path
    plan = model._test_plan
    params = model.score_params()
    head = plan.chunks[0]
    proj = CoffeeModel.proj_chunk(params, head)
    v = params["item_panel"]
    out["fused_gap"] = _fused_gap(plan, proj, v, recs, v.shape[0])
    check(out["fused_gap"] < 1e-3, f"CoFFee fused_ok: re-scored gap "
          f"{out['fused_gap']:.2e} < 1e-3")
    check(torch.equal(proj, CoffeeModel.proj_chunk(params, head)),
          "two proj_chunk calls give bit-identical projections")
    pop = PopularityModel(data, device=device)
    pop.verbose = False
    out["popularity_hr10"] = float(pop.evaluate("relevance").hr)
    check(out["hr10"] > out["popularity_hr10"],
          f"CoFFee HR@{TOPK} {out['hr10']:.5f} > popularity's "
          f"{out['popularity_hr10']:.5f}")
    again = coffee_model(data, device)
    again.build()
    check(all(torch.equal(f, again.factors[name])
              for name, f in model.factors.items()),
          "two builds with one seed give identical factor bits")
    del again

    # the kernel at CoFFee's scoring shape (popularity-ordered panel)
    perm, inv = plan.pop_order(v.shape[0])
    panel = v.index_select(0, torch.as_tensor(perm, device=v.device))
    bits = plan.seen_bits(0, v.shape[0], col_map=inv,
                          map_token=("pop", v.shape[0]))
    out["kernel"] = mesh_shard_fields(proj.contiguous(), panel.contiguous(),
                                      bits, v.shape[0], device)
    out["sweep_split_ms"] = hooi_sweep_split_ms(
        idx, val, shape, [model.factors[k] for k in data.fields])
    log(f"  one sweep (ms): {json.dumps(out['sweep_split_ms'])}")

    # ---- the rank search over benchmarks/ml10m_coffee.py's grid
    tuned = coffee_model(data, device)
    fused_score_topk.launches = 0
    t0 = wall()
    best, table = find_optimal_tucker_ranks(
        tuned, TUCKER_GRID, "hr", return_scores=True,
        metric_type="relevance", topk=TOPK)
    out["tuning_s"] = wall() - t0
    out["tuning_max_build_s"] = tuned.training_time[-1]
    out["launches"]["tuning"] = fused_score_topk.launches
    out["tuning_cells"] = int(len(table))
    out["best_mlrank"] = [int(r) for r in best]
    tuned.mlrank = tuple(out["best_mlrank"])
    t0 = wall()
    tuned.build()
    out["tuned_build_s"] = wall() - t0
    tuned_scores = tuned.evaluate(["relevance", "ranking"])
    out["tuned_hr10"] = float(tuned_scores[0].hr)
    out["tuned_mrr10"] = float(tuned_scores[1].mrr)
    svd = SVDModel(data, device=device)
    svd.verbose = False
    svd.rank = RANK
    svd.svd_method = "krylov"
    out["puresvd_hr10"] = float(svd.evaluate("relevance").hr)
    del svd, tuned
    log(f"  rank search: {out['tuning_cells']} cells in "
        f"{out['tuning_s']:.2f} s (max-rank build "
        f"{out['tuning_max_build_s']:.2f} s); best mlrank "
        f"{tuple(out['best_mlrank'])}: HR@{TOPK} {out['tuned_hr10']:.5f} "
        f"MRR@{TOPK} {out['tuned_mrr10']:.5f} (build "
        f"{out['tuned_build_s']:.2f} s); PureSVD-{RANK} (Krylov) HR@{TOPK} "
        f"{out['puresvd_hr10']:.5f}")
    check(np.isfinite(table.values).all() and out["tuning_cells"] > 0,
          "every searched cell's HR@10 is finite")

    # ---- distributed_hooi on a (4, 1) mesh against hooi, 3 sweeps
    mesh41 = make_mesh(devices=mesh_devices(4, device), shape=(4, 1))
    mesh22 = make_mesh(devices=mesh_devices(4, device), shape=(2, 2))
    kw = dict(num_iters=3, growth_tol=0.0, seed=0)
    with Timer() as t:
        single = hooi(idx, val, shape, MLRANK, device=device, **kw)
    out["hooi_3_sweeps_s"] = t.seconds
    with Timer() as t:
        dist = distributed_hooi(idx, val, shape, MLRANK, mesh41, **kw)
    out["distributed_hooi_3_sweeps_s"] = t.seconds
    out["distributed_hooi_max_sin"] = max(
        max_sin(a, b) for a, b in zip(dist[:3], single[:3]))
    check(out["distributed_hooi_max_sin"] < 1e-4,
          f"distributed_hooi (4, 1) vs hooi, 3 sweeps from one start: "
          f"principal angles (max sin) {out['distributed_hooi_max_sin']:.2e}"
          f" < 1e-4")
    del single, dist

    # ---- mesh scoring of the built factors, counted
    fused_score_topk.launches = 0
    want = model._device_recommendations()
    out["mesh_expected"] = {}
    for name, mesh in (("tensor_mesh_1d", mesh41), ("tensor_mesh_2d",
                                                    mesh22)):
        before = fused_score_topk.launches
        meshed = coffee_model(data, device, mesh=mesh)
        meshed.set_factors(model.factors)
        got = meshed._device_recommendations()
        out["launches"][name] = fused_score_topk.launches - before
        out["mesh_expected"][name] = 4 * len(meshed._test_plan.chunks)
        check(torch.equal(got, want), f"CoffeeModel on {name}: ids == one "
              f"device's (the same factors)")
    out["launches"]["tensor_mesh"] = fused_score_topk.launches

    if trained is not None:
        trained["coffee"] = ServingBundle.from_model(model, topk=TOPK,
                                                     batch_size=SERVE_BATCH)
    del model, recs, proj, plan
    gc.collect()

    # ---- the dense tier against the event tier at small_geometry
    small = coffee_data(small_geometry, device, warm_start=False)
    tiers = {}
    saved = config.get_default("hbm_score_budget_gb")
    try:
        for tier, budget_gb in (("dense", saved), ("events", 1e-9)):
            config.set_default("hbm_score_budget_gb", budget_gb)
            m = coffee_model(small, device)
            t0 = wall()
            m.build()
            tiers[tier] = (m, wall() - t0, float(m.evaluate("relevance").hr))
    finally:
        config.set_default("hbm_score_budget_gb", saved)
    check(("coffee_tensor", torch.float32, tiers["dense"][0].device)
          in small.__dict__["_device_matrix_cache"],
          "the small geometry's build took the dense tier (tensor cached)")
    out["small_tiers"] = {tier: {"build_s": s, "hr10": hr,
                                 "sweeps": len(m.growth_history)}
                          for tier, (m, s, hr) in tiers.items()}
    out["small_tiers_max_sin"] = max(
        max_sin(tiers["dense"][0].factors[k], tiers["events"][0].factors[k])
        for k in small.fields)
    out["small_tiers_hr_delta"] = abs(tiers["dense"][2] - tiers["events"][2])
    log(f"  {small_geometry}: {json.dumps(out['small_tiers'])}")
    check(out["small_tiers_max_sin"] < 1e-3
          and out["small_tiers_hr_delta"] <= 1e-3,
          f"dense tier vs event tier from one start: principal angles "
          f"(max sin) {out['small_tiers_max_sin']:.2e} < 1e-3, |dHR@{TOPK}| "
          f"{out['small_tiers_hr_delta']:.2e} <= 1e-3")
    predicted = tiers["events"][0].predict_feedback()
    trained_levels = set(small.training[feedback].unique().tolist())
    check(set(np.unique(predicted).tolist()) <= trained_levels,
          f"predict_feedback returns trained rating values only "
          f"({sorted(set(np.unique(predicted).tolist()))})")
    del tiers, small
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None)
    out["phase_s"] = wall() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 9: the serving entry point
# --------------------------------------------------------------------------

# benchmarks/serving_throughput.py: batch 1,024, 100-event histories
SERVE_BATCH, SERVE_EVENTS = 1024, 100


def serving_requests(n_items, rs):
    """One batch of each request kind: id lists of 100 events (bucket
    128), of 50 (bucket 64) and of 200 (bucket 256); rating dicts of 100
    events (ratings 1..5); dense profiles of the same 100 events."""
    def lists(width):
        picks = np.argpartition(rs.rand(SERVE_BATCH, n_items), width,
                                axis=1)[:, :width]
        return [row.tolist() for row in picks]
    out = {f"ids_{w}": lists(w) for w in (SERVE_EVENTS, 50, 200)}
    ratings = rs.randint(1, 6, (SERVE_BATCH, SERVE_EVENTS))
    out["dicts_100"] = [dict(zip(items, r.tolist())) for items, r in
                        zip(out[f"ids_{SERVE_EVENTS}"], ratings)]
    profiles = np.zeros((SERVE_BATCH, n_items), np.float32)
    rows = np.repeat(np.arange(SERVE_BATCH), SERVE_EVENTS)
    profiles[rows, np.concatenate(out[f"ids_{SERVE_EVENTS}"])] = \
        ratings.ravel()
    out["dense"] = profiles
    return out


def serve_step_fields(bundle, requests, reps=5):
    """One request kind through the bundle: the whole call by the host
    clock; the host assembly (the padded block); the device part (the
    block's transfer, ``proj``, seen bits and the kernel) by CUDA events;
    the kernel alone on the step's own inputs."""
    import torch
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 pack_seen_bits)
    dense = isinstance(requests, np.ndarray)
    call = (bundle.recommend if dense else bundle.recommend_events)
    call(requests)
    walls = []
    for _ in range(reps):
        t0 = wall()
        call(requests)
        walls.append(wall() - t0)
    fields = {"wall_ms": 1e3 * float(np.median(walls))}
    if dense:
        t0 = time.perf_counter()
        block = bundle.assemble_dense(requests)
        fields["host_ms"] = 1e3 * (time.perf_counter() - t0)

        def device_part():
            return bundle.rank(bundle.dense_step_inputs(
                block.to(bundle.device)))
        inputs = bundle.dense_step_inputs(block.to(bundle.device))
    else:
        t0 = time.perf_counter()
        assembled = bundle.assemble_events(requests)
        fields["host_ms"] = 1e3 * (time.perf_counter() - t0)
        fields["width"] = int(assembled[0].shape[1])

        def to_dev():
            return [None if x is None else torch.as_tensor(x).to(
                bundle.device) for x in assembled]

        def device_part():
            return bundle.rank(bundle.events_step_inputs(*to_dev()))
        inputs = bundle.events_step_inputs(*to_dev())
    proj, rows, cols = inputs
    proj = proj.float().contiguous()
    bits = pack_seen_bits(rows, cols, proj.shape[0], bundle.n_items)
    if proj.is_cuda:
        fields["device_ms"] = time_ms(device_part, reps)
        fields["device_users_per_s"] = len(requests) / (
            fields["device_ms"] / 1e3)
        fields["kernel_ms"] = time_ms(lambda: fused_score_topk(
            proj, bundle.left_panel, bits, bundle.topk), reps)
        fields["kernel_share"] = fields["kernel_ms"] / fields["wall_ms"]
    fields["host_share"] = fields["host_ms"] / fields["wall_ms"]
    fields["users_per_s"] = len(requests) / (fields["wall_ms"] / 1e3)
    return fields, (proj, bits)


def serving_phase(trained, device="cuda"):
    """Phase 9: ``ServingBundle`` at the ML-10M catalog over the factors
    of phases 3 (PureSVD, projection), 7 (iALS fold-in, BPR ridge) and 8
    (CoFFee value map), batch 1,024, top-10, counted; then the gates:
    each step's kernel against its plain version (integer factors: ids
    identical for the projection steps; fold-in solves and trained
    factors: re-scored picks), the short row, a save/load round trip.
    Returns the measured fields; the caller checks the launch counts."""
    import tempfile
    from pathlib import Path

    import torch
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.runtime.serving import ServingBundle

    t_phase = wall()
    ials = {"kind": "ials", "alpha": IALS["alpha"], "weight": IALS["weight"],
            "epsilon": IALS["epsilon"], "reg": IALS["reg"]}
    bundles = {
        "svd": ServingBundle(trained["svd"], topk=TOPK,
                             batch_size=SERVE_BATCH),
        "ials": ServingBundle(trained["ials"], topk=TOPK,
                              batch_size=SERVE_BATCH, fold_in=ials),
        "bpr": ServingBundle(trained["bpr"], topk=TOPK,
                             batch_size=SERVE_BATCH,
                             fold_in={"kind": "ridge", "reg": IALS["reg"]}),
        "coffee": trained["coffee"]}
    n_items = bundles["svd"].n_items
    rs = np.random.RandomState(0)
    requests = serving_requests(n_items, rs)
    kinds = {"svd": ("ids_100", "dicts_100", "ids_50", "ids_200", "dense"),
             "ials": ("ids_100", "dicts_100", "ids_50", "ids_200", "dense"),
             "bpr": ("ids_100", "ids_50", "ids_200", "dense"),
             "coffee": ("dicts_100", "ids_100", "ids_50", "ids_200",
                        "dense")}
    out = {"steps": {}, "launches": {}}
    # ---- the drive, counted: each shape once, then one batch of each kind
    fused_score_topk.launches = 0
    for name, bundle in bundles.items():
        before = fused_score_topk.launches
        bundle.warmup(event_widths=(64, 128, 256), explicit_values=True)
        for kind in kinds[name]:
            call = (bundle.recommend if kind == "dense"
                    else bundle.recommend_events)
            recs = call(requests[kind])
            check(recs.shape == (SERVE_BATCH, TOPK)
                  and ((recs >= 0) & (recs < n_items)).all(),
                  f"{name} {kind}: {SERVE_BATCH} x {TOPK} ids in range")
        out["launches"][name] = fused_score_topk.launches - before
    out["launches"]["serving"] = fused_score_topk.launches

    # ---- times per step
    inputs = {}
    for name, bundle in bundles.items():
        out["steps"][name] = {}
        for kind in kinds[name]:
            fields, inputs[name, kind] = serve_step_fields(bundle,
                                                           requests[kind])
            out["steps"][name][kind] = fields
        log(f"  {name}: " + json.dumps({k: {f: round(x, 4) for f, x in
                                            v.items()} for k, v in
                                        out["steps"][name].items()}))

    # ---- gates (comparison launches are not counted above)
    for name, bundle in bundles.items():
        for kind in kinds[name]:
            proj, bits = inputs[name, kind]
            log(f"  {name} {kind}: kernel vs plain version (trained)")
            _compare(proj, bundle.left_panel.contiguous(), bits, TOPK)
    gen = torch.Generator(device=device).manual_seed(0)
    for name, bundle in bundles.items():
        shape = tuple(bundle.item_factors.shape)
        factors = torch.randint(-2, 3, shape, generator=gen,
                                device=device).float()
        kw = {"topk": TOPK, "batch_size": SERVE_BATCH}
        if bundle.fold_in is not None:
            kw["fold_in"] = bundle.fold_in
        if bundle.value_map is not None:
            kw["value_map"] = {k: float(i - 1) for i, k in
                               enumerate(sorted(bundle.value_map))}
            kw["default_weight"] = float(len(bundle.value_map) - 2)
        twin = ServingBundle(factors, **kw)
        exact = bundle.fold_in is None
        for kind in kinds[name][:2] + ("dense",):
            _, (proj, bits) = serve_step_fields(twin, requests[kind], reps=1)
            log(f"  {name} {kind}: kernel vs plain version (integer "
                f"factors{', ids identical' if exact else ''})")
            _compare(proj, twin.left_panel.contiguous(), bits, TOPK,
                     exact=exact)
    proj, bits = inputs["svd", f"ids_{SERVE_EVENTS}"]
    out["kernel"] = mesh_shard_fields(proj, bundles["svd"].left_panel,
                                      bits, n_items, device)
    seen = rs.permutation(n_items)[:n_items - 3]
    unseen = sorted(set(range(n_items)) - set(seen.tolist()))
    for name, bundle in bundles.items():
        for got in (bundle.recommend_events([seen.tolist()])[0],
                    bundle.recommend(np.isin(np.arange(n_items), seen)[None]
                                     .astype(np.float32) * 4)[0]):
            check(sorted(got[:3].tolist()) == unseen
                  and got[3:].tolist() == sorted(seen.tolist())[:TOPK - 3],
                  f"{name}: a request that has seen all but 3 items gets "
                  "them first, then its seen items in ascending id order")
    build_dir = Path(__file__).resolve().parent / "polara_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        for name, bundle in bundles.items():
            path = str(Path(tmp) / f"{name}.npz")
            bundle.save(path)
            loaded = ServingBundle.load(path, device=device)
            kind = kinds[name][0]
            check(np.array_equal(loaded.recommend_events(requests[kind]),
                                 bundle.recommend_events(requests[kind])),
                  f"{name}: save -> load gives identical ids")
    out["phase_s"] = wall() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 10: the side-information path
# --------------------------------------------------------------------------

# benchmarks/hybrid_svd.py: HybridSVD rank 30, features_weight 0.5
# (beta = 1), six power iterations, the similarity of a 32-wide base
HYBRID_RANK, HYBRID_ITERS, SIM_BASE = 30, 6, 32
# synthetic genres: 19 labels, 1-3 per item; KPMF's 10 nearest items
N_GENRES, GENRE_NEIGHBOURS = 19, 10
COLD_SVD_RANK, COLD_LCE_RANK = 50, 10


def synthetic_similarity(n_items, device, seed=0):
    """``benchmarks/hybrid_svd.py``'s item similarity drawn on ``device``
    (a ``torch.Generator``): ``base`` N(0, 1) of (n_items x 32), ``S =
    0.5 corr(base baseᵀ)`` with a unit diagonal, so ``S + I`` is positive
    definite (456 MB f32 at the ML-10M catalog; it never visits the
    host)."""
    import torch
    gen = torch.Generator(device=device).manual_seed(seed)
    base = torch.randn((n_items, SIM_BASE), generator=gen, device=device)
    sim = base @ base.T
    diag = torch.sqrt(torch.diagonal(sim))
    sim.div_(diag[:, None]).div_(diag[None, :]).mul_(0.5)
    return sim.fill_diagonal_(1.0)


def synthetic_movies(item_ids):
    """MovieLens's ``movieid/movienm/genres`` frame for ``item_ids``: 19
    genre labels, 1-3 per item, Zipf-skewed
    (``numpy.random.RandomState(0)``), ``|``-joined as in ``movies.dat``."""
    import pandas as pd
    rs = np.random.RandomState(0)
    weights = 1.0 / np.arange(1, N_GENRES + 1)
    weights /= weights.sum()
    names = np.array([f"genre{g:02d}" for g in range(N_GENRES)])
    genres = ["|".join(names[np.sort(rs.choice(N_GENRES, n, replace=False,
                                               p=weights))])
              for n in rs.randint(1, 4, len(item_ids))]
    return pd.DataFrame({"movieid": item_ids,
                         "movienm": [f"movie {i}" for i in item_ids],
                         "genres": genres})


def synthetic_genres(item_ids):
    """Genre lists per item (:func:`synthetic_movies`' strings read back
    through ``get_split_genres``); a one-column frame indexed by item
    id."""
    import pandas as pd
    from polara_tpu_torch.datasets import get_split_genres
    lists = get_split_genres(synthetic_movies(item_ids)).groupby(
        "movieid", sort=False)["genreid"].agg(list)
    return pd.DataFrame({"genres": lists}).reindex(item_ids)


def side_data(frame, cls, warm_start=True, **kwargs):
    """Phase 8's scenario (one random held-out event per test user, 20%
    test users, data seed 0) in the data model ``cls``."""
    data = cls(frame.copy(), "userid", "movieid", "rating", seed=0,
               verbose=False, **kwargs)
    data.warm_start = warm_start
    data.holdout_size = 1
    data.test_ratio = 0.2
    data.random_holdout = True
    data.prepare()
    return data


def hybrid_model(cls, data, device, rank=HYBRID_RANK, **attrs):
    """A SVD-family model at the benchmark's solver setting: six power
    iterations (no tolerance loop), seed 0."""
    model = cls(data, device=device, **attrs)
    model.verbose = False
    model.rank = rank
    model.svd_tol = None
    model.svd_iters = HYBRID_ITERS
    model.seed = 0
    return model


def dense_profiles(plan, n_items):
    """The test users' profile block (users x items) on the plan's
    device, built chunk by chunk from the plan's events."""
    import torch
    out = torch.zeros((plan.n_users, n_items), device=plan.device)
    for chunk in plan.chunks:
        rows = chunk.rows[chunk.valid] + chunk.start
        out.index_put_((rows, chunk.cols[chunk.valid]),
                       chunk.vals[chunk.valid].float())
    return out


def genre_laplacian(genres, device):
    """KPMF's item relations: the graph Laplacian
    (``compute_graph_laplacian``) of each item's ten nearest items by
    genre vector (``knn_graph`` over the stacked one-hot genres)."""
    import pandas as pd
    import torch
    from polara_tpu_torch.datasets import compute_graph_laplacian
    from polara_tpu_torch.models.hybrid import knn_graph
    from polara_tpu_torch.preprocessing.features import stack_features
    one_hot, _ = stack_features(genres, normalize=False)
    adjacency = knn_graph(torch.as_tensor(one_hot.toarray()).to(device),
                          GENRE_NEIGHBOURS)
    rows, cols = (x.cpu().numpy() for x in torch.nonzero(adjacency,
                                                         as_tuple=True))
    ids = genres.index.to_numpy()
    laplacian, _ = compute_graph_laplacian(zip(ids[rows], ids[cols]),
                                           pd.Index(ids))
    return laplacian


def _metric_fields(scores):
    return {name: float(value) for record in scores
            for name, value in record._asdict().items() if value is not None}


def side_phase(geometry, small_geometry, device="cuda"):
    """Phase 10: HybridSVD rank 30 at ``geometry`` through
    ``SimilarityDataModel`` (phase 8's scenario), scored through the
    kernel, beside ScaledHybridSVD, SIM, the S = I check against
    PureSVD-30 and a ``features_weight`` change; KPMF and LCE at
    ``small_geometry`` with known users; the item cold-start scenario at
    ``geometry``; the HybridSVD serving bundle.  Returns the measured
    fields; raises on a failed gate except the launch counts
    (``launches``), which the caller checks."""
    import torch
    from polara_tpu_torch.data import (ItemColdStartSimilarityData,
                                       RecommenderData, SideRelationsMixin,
                                       SimilarityDataModel)
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch import models as pm
    from polara_tpu_torch.ops.cholesky import CholeskyFactor, hybrid_operator
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.runtime.serving import ServingBundle

    t_phase = wall()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}}
    n_items = geometry["n_items"]
    frame = events_frame(*make_realistic_coo_device(**geometry, seed=0,
                                                    device=device))
    sim = synthetic_similarity(n_items, device)
    relations = {"relations_matrices": {"movieid": sim, "userid": None},
                 "relations_indices": {"movieid": np.arange(n_items),
                                       "userid": None}}
    t0 = wall()
    data = side_data(frame, SimilarityDataModel, **relations)
    out["prepare_s"] = wall() - t0

    # ---- HybridSVD as a user drives it: build, evaluate, counted
    fused_score_topk.launches = 0
    model = hybrid_model(pm.HybridSVD, data, device)
    t0 = wall()
    model.build()
    out["build_s"] = wall() - t0
    t0 = wall()
    scores = model.evaluate(["relevance", "ranking"])
    out["evaluate_s"] = wall() - t0
    out["hr10"], out["mrr10"] = float(scores[0].hr), float(scores[1].mrr)
    with Timer() as t:
        model.get_recommendations()
    out["scoring_warm_ms"] = t.seconds * 1e3
    out["launches"]["hybrid"] = fused_score_topk.launches
    recs = model._device_recommendations()
    log(f"  HybridSVD-{HYBRID_RANK}: build {out['build_s']:.3f} s, HR@{TOPK}"
        f" {out['hr10']:.5f} MRR@{TOPK} {out['mrr10']:.5f}; "
        f"{out['launches']['hybrid']} launch(es)")

    plan = model._test_plan
    params = model.score_params()
    head = plan.chunks[0]
    proj = pm.HybridSVD.proj_chunk(params, head)
    left = params["projector_left"]
    check(params["item_panel"] is left and model.uses_fused_scoring(params),
          "HybridSVD routes to the kernel over its left projector")
    out["fused_gap"] = _fused_gap(plan, proj, left, recs, n_items)
    check(out["fused_gap"] < 1e-3, f"HybridSVD fused_ok: re-scored gap "
          f"{out['fused_gap']:.2e} < 1e-3")
    check(torch.equal(proj, pm.HybridSVD.proj_chunk(params, head)),
          "two proj_chunk calls give bit-identical projections")
    pop = pm.PopularityModel(data, device=device)
    pop.verbose = False
    out["popularity_hr10"] = float(pop.evaluate("relevance").hr)
    check(out["hr10"] > out["popularity_hr10"],
          f"HybridSVD HR@{TOPK} {out['hr10']:.5f} > popularity's "
          f"{out['popularity_hr10']:.5f}")

    # the parts of the build at these inputs, and the kernel at this shape
    similarity = model.device_relations("movieid")
    chol = model.item_cholesky_factor
    v = model.factors["movieid"]
    if on_card:
        out["cholesky_ms"] = time_ms(
            lambda: CholeskyFactor.factorize(similarity, 1.0), 3)
        op = hybrid_operator(model.get_training_matrix().to_dense(), None,
                             chol.L)
        block = HYBRID_RANK + max(10, HYBRID_RANK)
        gen = torch.Generator(device=device).manual_seed(1)
        x = torch.randn((n_items, block), generator=gen, device=device)
        y = torch.randn((op.shape[0], block), generator=gen, device=device)
        out["operator_mm_ms"] = time_ms(lambda: op.mm(x), 5)
        out["operator_rmm_ms"] = time_ms(lambda: op.rmm(y), 5)
        del op, x, y
        out["projector_solves_ms"] = time_ms(
            lambda: (chol.T.solve(v), chol.dot(v)), 5)
    perm, inv = plan.pop_order(n_items)
    panel = left.index_select(0, torch.as_tensor(perm, device=left.device))
    bits = plan.seen_bits(0, n_items, col_map=inv,
                          map_token=("pop", n_items))
    out["kernel"] = mesh_shard_fields(proj.contiguous(), panel.contiguous(),
                                      bits, n_items, device)
    del panel, bits

    # ---- features_weight 0.5 -> 0.8 refactorizes in place and rebuilds
    before = chol.L[:64, :64].clone()
    t0 = wall()
    model.features_weight = 0.8
    out["refactorize_s"] = wall() - t0
    check(not model._is_ready and model.item_cholesky_factor is chol
          and not torch.equal(chol.L[:64, :64], before),
          "features_weight 0.5 -> 0.8 refactorizes the factor in place and "
          "renews the model")
    t0 = wall()
    out["hr10_weight_08"] = float(model.evaluate("relevance").hr)
    out["rebuild_s"] = wall() - t0
    check(model._is_ready and np.isfinite(out["hr10_weight_08"]),
          f"the model rebuilt (HR@{TOPK} {out['hr10_weight_08']:.5f} at "
          f"features_weight 0.8)")
    trained_hybrid = model
    del recs, proj, chol, before

    # ---- ScaledHybridSVD on the same data, counted
    fused_score_topk.launches = 0
    scaled = hybrid_model(pm.ScaledHybridSVD, data, device)
    out["scaled_hr10"] = float(scaled.evaluate("relevance").hr)
    out["launches"]["scaled_hybrid"] = fused_score_topk.launches
    sparams = scaled.score_params()
    out["scaled_fused_gap"] = _fused_gap(
        scaled._test_plan, pm.ScaledHybridSVD.proj_chunk(sparams, head),
        sparams["item_panel"], scaled._device_recommendations(), n_items)
    check(out["scaled_fused_gap"] < 1e-3, f"ScaledHybridSVD fused_ok: "
          f"re-scored gap {out['scaled_fused_gap']:.2e} < 1e-3")
    del scaled, sparams

    # ---- SimilarityAggregation (dense profile @ S, unfused)
    agg = pm.SimilarityAggregation(data, device=device)
    agg.verbose = False
    agg.build()
    aparams = agg.score_params()
    check(not agg.uses_fused_scoring(aparams),
          "SIM takes the unfused path (no proj_chunk)")
    t0 = wall()
    agg_recs = agg._device_recommendations()
    out["sim_scoring_s"] = wall() - t0
    out["sim_hr10"] = float(agg.evaluate("relevance").hr)
    n_check = min(VERIFY_USERS, plan.n_users)
    block = pm.SimilarityAggregation.score_chunk(aparams, head)[:n_check]
    sel = head.valid & (head.rows < n_check)
    block[head.rows[sel], head.cols[sel]] = -torch.inf
    plain = torch.sort(block, dim=1, descending=True,
                       stable=True).indices[:, :TOPK]
    check(torch.equal(agg_recs[:n_check].long(), plain),
          f"SIM picks == a plain stable-sort top-{TOPK} of its score block "
          f"(first {n_check} users)")
    if on_card:
        profiles = dense_profiles(plan, n_items)
        s = aparams["similarity"]
        out["sim_product_ms"] = time_ms(lambda: profiles @ s, 3)
        out["sim_product_shape"] = [plan.n_users, n_items, n_items]
        del profiles, s
    del agg, aparams, block, agg_recs

    # ---- S = I: HybridSVD is PureSVD rescaled on the same split
    eye = torch.eye(n_items, device=device)
    identity = side_data(frame, SimilarityDataModel, relations_matrices={
        "movieid": eye, "userid": None},
        relations_indices=relations["relations_indices"])
    fused_score_topk.launches = 0
    twin = hybrid_model(pm.HybridSVD, identity, device)
    twin_hr = float(twin.evaluate("relevance").hr)
    out["launches"]["hybrid_identity"] = fused_score_topk.launches
    pure = hybrid_model(pm.SVDModel, identity, device)
    out["puresvd_hr10"] = float(pure.evaluate("relevance").hr)
    out["identity_overlap"] = _overlap(twin._device_recommendations(),
                                       pure._device_recommendations())
    out["identity_hr_delta"] = abs(twin_hr - out["puresvd_hr10"])
    check(out["identity_overlap"] >= 0.99
          and out["identity_hr_delta"] <= 1e-3,
          f"S = I: HybridSVD-{HYBRID_RANK} vs PureSVD-{HYBRID_RANK} top-"
          f"{TOPK} overlap {out['identity_overlap']:.5f} >= 0.99, |dHR@"
          f"{TOPK}| {out['identity_hr_delta']:.2e} <= 1e-3 (PureSVD HR@"
          f"{TOPK} {out['puresvd_hr10']:.5f})")
    del twin, pure, identity, eye, data, plan, head, pop
    gc.collect()

    # ---- HybridSVD serving: the bundle from the model, counted
    rs = np.random.RandomState(0)
    requests = serving_requests(n_items, rs)
    fused_score_topk.launches = 0
    bundle = ServingBundle.from_model(trained_hybrid, topk=TOPK,
                                      batch_size=SERVE_BATCH)
    check(bundle.left_panel is not bundle.item_factors,
          "the HybridSVD bundle serves two panels (right, left)")
    bundle.warmup(event_widths=(128,), explicit_values=True)
    for kind in ("ids_100", "dicts_100"):
        got = bundle.recommend_events(requests[kind])
        check(got.shape == (SERVE_BATCH, TOPK)
              and ((got >= 0) & (got < n_items)).all(),
              f"HybridSVD bundle {kind}: {SERVE_BATCH} x {TOPK} ids in "
              f"range")
    out["launches"]["hybrid_serving"] = fused_score_topk.launches
    out["serving"], _ = serve_step_fields(bundle, requests["ids_100"])
    gen = torch.Generator(device=device).manual_seed(0)
    right, left_twin = (torch.randint(-2, 3, tuple(bundle.item_factors.shape),
                                      generator=gen, device=device).float()
                        for _ in range(2))
    twin_bundle = ServingBundle(right, topk=TOPK, batch_size=SERVE_BATCH,
                                left_panel=left_twin)
    for kind in ("ids_100", "dicts_100"):
        _, (tproj, tbits) = serve_step_fields(twin_bundle, requests[kind],
                                              reps=1)
        log(f"  hybrid bundle {kind}: kernel vs plain version (integer "
            f"factors, left != right, ids identical)")
        _compare(tproj, twin_bundle.left_panel.contiguous(), tbits, TOPK,
                 exact=True)
    del bundle, twin_bundle, trained_hybrid

    # ---- KPMF and LCE at small_geometry, known users
    small = events_frame(*make_realistic_coo_device(**small_geometry,
                                                    seed=0, device=device))
    genres = synthetic_genres(np.arange(small_geometry["n_items"]))
    t0 = wall()
    laplacian = genre_laplacian(genres, device)
    out["laplacian_s"] = wall() - t0

    class LaplacianData(SideRelationsMixin, RecommenderData):
        pass

    kdata = side_data(small, LaplacianData, warm_start=False,
                      relations_matrices={"movieid": laplacian,
                                          "userid": None},
                      relations_indices={
                          "movieid": genres.index.to_numpy(),
                          "userid": None})
    fused_score_topk.launches = 0
    kpmf = pm.KernelizedPMF(kdata, device=device, seed=0)
    kpmf.verbose = False
    kpmf.num_epochs = 5
    kpmf.tolerance = 0.0
    t0 = wall()
    kpmf.build()
    out["kpmf_build_s"] = wall() - t0
    out["kpmf_rmse"] = list(kpmf.rmse_history)
    out["kpmf_hr10"] = float(kpmf.evaluate("relevance").hr)
    out["launches"]["kpmf"] = fused_score_topk.launches
    out["kpmf_fused_gap"] = _known_user_gap(kpmf)
    check(out["kpmf_fused_gap"] < 1e-3, f"KPMF fused_ok: re-scored gap "
          f"{out['kpmf_fused_gap']:.2e} < 1e-3")
    rmse = np.asarray(out["kpmf_rmse"])
    check(len(rmse) == 5 and np.isfinite(rmse).all()
          and (np.diff(rmse) <= 0).all(),
          f"KPMF RMSE finite and not rising over 5 epochs "
          f"({', '.join(f'{x:.5f}' for x in rmse)})")
    fused_score_topk.launches = 0
    lce = pm.LCEModel(kdata, item_features=genres, device=device)
    lce.verbose = False
    lce.seed = 0
    t0 = wall()
    lce.build()
    out["lce_build_s"] = wall() - t0
    out["lce_hr10"] = float(lce.evaluate("relevance").hr)
    out["launches"]["lce"] = fused_score_topk.launches
    out["lce_fused_gap"] = _known_user_gap(lce)
    check(out["lce_fused_gap"] < 1e-3, f"LCE fused_ok: re-scored gap "
          f"{out['lce_fused_gap']:.2e} < 1e-3")
    history = np.asarray(lce.objective_history)
    out["lce_objective"] = [float(history[0]), float(history[-1]),
                            len(history)]
    # multiplicative updates never raise the objective in exact
    # arithmetic; f32 sums may wobble by a few ulps of ~1e7
    check((np.diff(history) <= 1e-6 * np.abs(history[:-1])).all(),
          f"LCE objective does not rise over {len(history)} updates "
          f"({history[0]:.6e} -> {history[-1]:.6e})")
    kpop = pm.PopularityModel(kdata, device=device)
    kpop.verbose = False
    out["small_popularity_hr10"] = float(kpop.evaluate("relevance").hr)
    log(f"  {small_geometry}: KPMF HR@{TOPK} {out['kpmf_hr10']:.5f} "
        f"(build {out['kpmf_build_s']:.2f} s), LCE HR@{TOPK} "
        f"{out['lce_hr10']:.5f} (build {out['lce_build_s']:.2f} s), "
        f"popularity {out['small_popularity_hr10']:.5f}")
    del kpmf, lce, kpop, kdata, small

    # ---- the item cold-start scenario at geometry
    genres = synthetic_genres(np.arange(n_items))
    t0 = wall()
    cdata = ItemColdStartSimilarityData(
        frame, "userid", "movieid", "rating", item_features=genres,
        seed=0, verbose=False, **relations)
    cdata.prepare()
    out["cold_prepare_s"] = wall() - t0
    n_cold = cdata.index.itemid.cold_start.shape[0]
    n_users = cdata.index.userid.training.shape[0]
    out["cold_shape"] = [n_cold, n_users]
    cold_models = [
        ("MP(cs)", pm.PopularityModelItemColdStart, {}, {}),
        ("RND(cs)", pm.RandomModelItemColdStart, {"seed": 0}, {}),
        ("SIM(cs)", pm.SimilarityAggregationItemColdStart, {}, {}),
        ("PureSVD(cs)", pm.SVDModelItemColdStart, {},
         {"rank": COLD_SVD_RANK}),
        ("PureSVD-s(cs)", pm.ScaledSVDItemColdStart, {},
         {"rank": COLD_SVD_RANK}),
        ("HybridSVD(cs)", pm.HybridSVDItemColdStart, {},
         {"rank": HYBRID_RANK}),
        ("LCE(cs)", pm.LCEModelItemColdStart, {"item_features": genres},
         {"rank": COLD_LCE_RANK, "seed": 0}),
    ]
    out["cold"] = {}
    for name, cls, kw, attrs in cold_models:
        if "rank" in attrs and cls is not pm.LCEModelItemColdStart:
            cm = hybrid_model(cls, cdata, device, rank=attrs["rank"], **kw)
        else:
            cm = cls(cdata, device=device, **kw)
            cm.verbose = False
            for key, value in attrs.items():
                setattr(cm, key, value)
        t0 = wall()
        crecs = cm.recommendations
        seconds = wall() - t0
        metrics = _metric_fields(cm.evaluate(["relevance", "hits"]))
        # hits per cold item (the simple rate of a many-event holdout)
        metrics["hr"] = float(cm.evaluate("relevance", simple_rates=True).hr)
        out["cold"][name] = {"s": seconds, **metrics}
        check(crecs.shape == (n_cold, TOPK)
              and ((crecs >= 0) & (crecs < n_users)).all()
              and all(np.isfinite(x) for x in metrics.values()),
              f"{name}: {n_cold} x {TOPK} user ids in range, finite "
              f"metrics (precision {metrics['precision']:.5f}, "
              f"{seconds:.2f} s)")
        if name == "HybridSVD(cs)":
            cscores = cm.compute_cold_scores(None)
            plain = torch.sort(cscores, dim=1, descending=True,
                               stable=True).indices[:, :TOPK]
            check(np.array_equal(crecs, plain.cpu().numpy()),
                  "HybridSVD(cs) picks == a plain stable-sort top-"
                  f"{TOPK} of its score block")
            del cscores, plain
        del cm
    for name in ("PureSVD(cs)", "HybridSVD(cs)"):
        check(out["cold"][name]["true_positive"]
              > out["cold"]["RND(cs)"]["true_positive"],
              f"{name} hits {out['cold'][name]['true_positive']:.0f} > "
              f"RND(cs)'s {out['cold']['RND(cs)']['true_positive']:.0f}")
    log("  cold start: " + json.dumps({k: {f: round(x, 5) for f, x in
                                           v.items()} for k, v in
                                       out["cold"].items()}))
    del cdata, frame, sim
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None)
    out["phase_s"] = wall() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 11: the beyond-memory streaming tier at Netflix geometry
# --------------------------------------------------------------------------

KRYLOV_DEPTH = 3             # benchmarks/netflix_scale.py:64
JAX_HEAD_GB = 2.0            # the JAX package's streaming_head_gb
STREAM_EVENT_CHUNK = 4_000_000
MESH_ITERS = 4               # distributed_chunked_rsvd's power iterations
GRAM_BLOCK_ROWS = 8192       # dense f64 row blocks of the exact Gram
STREAM_IALS_BUDGET_GB = 2.0  # below ML-10M's 2.78 GiB dense block


def holdout_split_device(rows, n_users: int, seed: int = 7):
    """:func:`holdout_split` on the card, for row-sorted event tensors in
    which every user has an event: the same ``RandomState`` draws, so the
    same picks.  Returns (picked event positions, held-out mask)."""
    import torch
    counts = torch.bincount(rows, minlength=n_users)
    check(bool((counts > 0).all()), "every user has an event")
    start = torch.cumsum(counts, 0) - counts
    draw = torch.as_tensor(np.random.RandomState(seed).rand(n_users),
                           device=rows.device)
    pick = start + (draw * counts).long()
    hold = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    hold[pick] = True
    return pick, hold


def profile_ms(fn, top=8):
    """One call of ``fn`` under ``torch.profiler``: its wall ms (host
    clock, synchronized), the card's busy ms (the kernels' self device
    time, one stream), the idle share, and the ``top`` kernels by device
    time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = wall()
        fn()
        wall_ms = (wall() - t0) * 1e3
    kernels = []
    for event in prof.key_averages():
        # device activity only: the aten ops would count their kernels
        # twice, and the runtime's stall marker is no device work
        if (getattr(event, "device_type", None) != DeviceType.CUDA
                or event.key == "Command Buffer Full"):
            continue
        us = getattr(event, "self_device_time_total", None)
        if us is None:
            us = getattr(event, "self_cuda_time_total", 0)
        if us > 0:
            kernels.append((event.key[:80], us / 1e3))
    kernels.sort(key=lambda kv: -kv[1])
    busy = sum(ms for _, ms in kernels)
    return {"wall_ms": wall_ms, "busy_ms": busy,
            "idle_share": 1.0 - busy / wall_ms if wall_ms else None,
            "top": kernels[:top]}


def exact_item_factors(rows, cols, vals, n_users, n_items, rank,
                       block=GRAM_BLOCK_ROWS):
    """Exact f64 top-``rank`` item factors and singular values from the
    eigendecomposition of ``AᵀA``, accumulated over dense f64 row blocks
    of ``block`` users built on the card from the (row-sorted) events: no
    whole dense block is ever made."""
    import torch
    gram = torch.zeros((n_items, n_items), dtype=torch.float64,
                       device=rows.device)
    starts = list(range(0, n_users, block)) + [n_users]
    bounds = torch.searchsorted(
        rows, torch.as_tensor(starts, device=rows.device)).tolist()
    for b, lo_row in enumerate(starts[:-1]):
        lo, hi = bounds[b], bounds[b + 1]
        blk = torch.zeros((starts[b + 1] - lo_row, n_items),
                          dtype=torch.float64, device=rows.device)
        blk.index_put_((rows[lo:hi] - lo_row, cols[lo:hi]),
                       vals[lo:hi].double(), accumulate=True)
        gram.addmm_(blk.T, blk)
    del blk
    evals, evecs = torch.linalg.eigh(gram)
    del gram
    return (evecs[:, -rank:].flip(1).contiguous(),
            evals[-rank:].flip(0).clamp(min=0).sqrt())


def streaming_phase(geometry, ials_geometry, device="cuda",
                    ials_budget_gb=STREAM_IALS_BUDGET_GB):
    """Phase 11: PureSVD rank 50 at Netflix geometry through the streaming
    operators (split head at the JAX package's 2 GiB and at the port's
    budget, tiled), every user scored through the kernel; the mesh tiers
    (``distributed_chunked_rsvd``, ``ImplicitALS`` past the budget); the
    exact f64 reference; the dense route's build time.  ``ials_budget_gb``
    is the memory budget under which iALS at ``ials_geometry`` must take
    the event tier.  Returns the measured fields; raises on a failed gate
    except the launch counts (``launches``), which the caller checks."""
    import torch
    from polara_tpu_torch import config
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.models import ImplicitALS
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 fused_score_topk_reference,
                                                 pack_seen_bits, seen_mask)
    from polara_tpu_torch.ops.rsvd import (randomized_svd,
                                           randomized_svd_krylov)
    from polara_tpu_torch.ops.sparse import (dense_operator,
                                             resolve_head_budget,
                                             split_coo_operator,
                                             tiled_coo_operator)
    from polara_tpu_torch.parallel import distributed as dist_module
    from polara_tpu_torch.runtime.memory import plan_user_chunks
    from polara_tpu_torch.runtime.mesh import make_mesh

    t_phase = wall()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    n_users, n_items = geometry["n_users"], geometry["n_items"]
    shape = (n_users, n_items)
    out = {"staging_s": {}, "build_s": {}, "build_warm_s": {},
           "heads": {}, "metrics": {}, "launches": {}, "round_trip_ms": {}}

    # ---- data: one held-out event per user, training seen bits on the card
    with Timer() as t:
        rows, cols, vals = make_realistic_coo_device(**geometry, seed=0,
                                                     device=device)
    out["data_gen_s"] = t.seconds
    out["n_events"] = int(rows.shape[0])
    pick, hold = holdout_split_device(rows, n_users)
    hold_items = cols[pick]
    keep = ~hold
    rows, cols, vals = rows[keep], cols[keep], vals[keep]
    del pick, hold, keep
    out["train_events"] = int(rows.shape[0])
    log(f"  {out['n_events']} events, {n_users} x {n_items} "
        f"({out['data_gen_s']:.1f} s); {out['train_events']} training")
    counts = torch.bincount(cols, minlength=n_items)
    perm = torch.sort(counts, descending=True, stable=True).indices
    inv = torch.empty_like(perm)
    inv[perm] = torch.arange(n_items, device=perm.device)
    with Timer() as t:
        bits = pack_seen_bits(rows, inv[cols], n_users, n_items)
    out["seen_bits_ms"] = t.seconds * 1e3
    out["seen_bits_gib"] = bits.numel() * 4 / 2 ** 30

    def score_all(u, s, v):
        """Every user's top-10 through the kernel over the popularity-
        ordered panel, ``proj = u · diag(s)`` (= A v: the Rayleigh-Ritz
        identity), ids mapped back."""
        proj = (u * s[None, :]).contiguous()
        panel = v.index_select(0, perm).contiguous()
        pos = fused_score_topk(proj, panel, bits, TOPK,
                               n_valid_cols=n_items, tile_skip=True)
        check(bool((pos >= 0).all()), "no PAD slot (every user has "
              f"{TOPK} unseen items)")
        return perm[pos.long()], proj, panel

    def metrics(name, recs):
        hr, ndcg = _hit_metrics(recs, hold_items)
        out["metrics"][name] = {"hr": hr, "ndcg": ndcg}
        log(f"  {name}: HR@{TOPK} {hr:.5f} NDCG@{TOPK} {ndcg:.5f}")

    # ---- operators, each staging timed
    budgets = {"split_jax": JAX_HEAD_GB,
               "split_port": resolve_head_budget(
                   config.get_default("streaming_head_gb"), device)}
    ops = {}
    for name in ("split_jax", "split_port", "tiled"):
        if on_card:
            torch.cuda.empty_cache()
        with Timer() as t:
            if name == "tiled":
                ops[name] = tiled_coo_operator(
                    rows, cols, vals, shape, event_chunk=STREAM_EVENT_CHUNK,
                    assume_sorted=True)
            else:
                ops[name] = split_coo_operator(
                    rows, cols, vals, shape, head_budget_gb=budgets[name],
                    event_chunk=STREAM_EVENT_CHUNK, assume_sorted=True)
        out["staging_s"][name] = t.seconds
        if name != "tiled":
            (d, head_ids), row_side, _ = ops[name].operands
            check(ops[name].mm_fn.__name__ == "_split_mm",
                  f"{name}: the split head was taken")
            in_head = counts[head_ids].sum().item()
            covered = in_head / out["train_events"]
            out["heads"][name] = {
                "budget_gib": budgets[name], "p": int(d.shape[2]),
                "coverage": covered, "dtype": str(d.dtype),
                "head_gib": d.numel() * d.element_size() / 2 ** 30,
                "tail_events": out["train_events"] - in_head,
                "tail_row_slots": 0 if row_side is None else
                row_side.minor.shape[0]}
            log(f"  {name}: P {d.shape[2]}, coverage {covered:.4f}, "
                f"{d.dtype} head {out['heads'][name]['head_gib']:.2f} GiB "
                f"(budget {budgets[name]:.2f} GiB); staged in "
                f"{t.seconds:.2f} s")
        else:
            log(f"  tiled: staged in {t.seconds:.2f} s")

    # ---- the main path: a depth-3 Krylov build through each operator,
    # every user scored through the kernel (counted)
    def build(op):
        return randomized_svd_krylov(op, RANK, depth=KRYLOV_DEPTH, seed=0)

    results, recs = {}, {}
    fused_score_topk.launches = 0
    for name, op in ops.items():
        before = fused_score_topk.launches
        with Timer() as t:
            results[name] = build(op)
        out["build_s"][name] = t.seconds
        recs[name], proj, panel = score_all(*results[name])
        out["launches"][name] = fused_score_topk.launches - before
        metrics(name, recs[name])
    out["launches"]["main"] = fused_score_topk.launches

    # ---- checks per build
    for name, op in ops.items():
        u, s, v = results[name]
        check(bool(((recs[name] >= 0) & (recs[name] < n_items)).all()),
              f"{name}: every id in [0, {n_items})")
        av = op.mm(v) - u * s[None, :]
        atu = op.rmm(u) - v * s[None, :]
        out.setdefault("triplet_residual", {})[name] = (
            torch.linalg.norm(av, dim=0) / s[0]).max().item()
        out.setdefault("transpose_residual", {})[name] = (
            torch.linalg.norm(atu, dim=0) / s[0]).max().item()
        # Krylov's Rayleigh-Ritz makes Av = su up to rounding; the
        # transpose side measures how far the build converged
        check(max(out["triplet_residual"][name],
                  out["transpose_residual"][name]) < 1e-2,
              f"{name}: triplet residuals |Av - su|/s1 "
              f"{out['triplet_residual'][name]:.3e} and |A'u - sv|/s1 "
              f"{out['transpose_residual'][name]:.3e} < 1e-2")
        del av, atu
    for name in ("split_jax", "split_port"):
        with Timer() as t:
            again = build(ops[name])
        out["build_warm_s"][name] = t.seconds
        check(all(torch.equal(a, b) for a, b in zip(again, results[name])),
              f"{name}: two builds give bit-identical factors")
    with Timer() as t:
        score_all(*results["split_port"])
    out["score_warm_s"] = t.seconds
    if on_card:
        out["build_profile"] = {name: profile_ms(lambda: build(op))
                                for name, op in ops.items()}
        log(f"  builds under the profiler: "
            f"{json.dumps(out['build_profile'])}")
    out["split_vs_tiled_overlap"] = _overlap(recs["split_port"],
                                             recs["tiled"])
    out["split_vs_tiled_sv_gap"] = ((results["split_port"].s
                                     - results["tiled"].s).abs()
                                    / results["tiled"].s).max().item()
    check(out["split_vs_tiled_overlap"] >= 0.99,
          f"split vs tiled: top-{TOPK} overlap "
          f"{out['split_vs_tiled_overlap']:.5f} >= 0.99")
    check(out["split_vs_tiled_sv_gap"] <= 5e-3,
          f"split vs tiled: relative singular-value gap "
          f"{out['split_vs_tiled_sv_gap']:.2e} <= 5e-3")

    # fused_ok and the kernel against its plain version on the first users
    proj_head = proj[:VERIFY_USERS].contiguous()
    bits_head = bits[:VERIFY_USERS].contiguous()
    plain = fused_score_topk_reference(proj_head, panel, bits_head, TOPK,
                                       n_valid_cols=n_items)
    kern = fused_score_topk(proj_head, panel, bits_head, TOPK,
                            n_valid_cols=n_items)
    s64 = proj_head.double() @ panel.double().T
    s_plain, s_kern = s64.gather(1, plain.long()), s64.gather(1, kern.long())
    out["fused_max_gap"] = ((s_plain - s_kern).abs().max().item()
                            / max(s_plain.abs().max().item(), 1e-6))
    check(out["fused_max_gap"] < 1e-3,
          f"fused_ok on the first {VERIFY_USERS} users: re-scored gap "
          f"{out['fused_max_gap']:.2e} < 1e-3")
    _, out["max_abs_err"] = _compare(proj_head, panel, bits_head, TOPK,
                                     n_valid=n_items)

    # popularity on the same split: the training counts as a rank-1 model
    before = fused_score_topk.launches
    pop, _, _ = score_all(torch.ones((n_users, 1), device=rows.device),
                          torch.ones(1, device=rows.device),
                          counts.float()[:, None])
    out["launches"]["popularity"] = fused_score_topk.launches - before
    metrics("popularity", pop)
    for name in ops:
        check(out["metrics"][name]["hr"] > out["metrics"]["popularity"]["hr"],
              f"{name}: HR@{TOPK} {out['metrics'][name]['hr']:.5f} > "
              f"popularity's {out['metrics']['popularity']['hr']:.5f}")

    # ---- mm and rmm at width 100: bit-identical, one round trip timed
    gen = torch.Generator(device=rows.device).manual_seed(0)
    wide = torch.randn((n_items, 100), generator=gen, device=rows.device)
    tall = torch.randn((n_users, 100), generator=gen, device=rows.device)
    for name, op in ops.items():
        check(torch.equal(op.mm(wide), op.mm(wide))
              and torch.equal(op.rmm(tall), op.rmm(tall)),
              f"{name}: two mm and two rmm calls give bit-identical "
              f"products")
        out["round_trip_ms"][name] = (time_ms(
            lambda: (op.mm(wide), op.rmm(tall)), 3) if on_card else None)
    log(f"  mm + rmm at width 100 (ms): {json.dumps(out['round_trip_ms'])}")
    if on_card:
        # the passes' row gather at one chunk (4M events x width 100): the
        # advanced-indexing kernel against index_select, which the passes
        # run
        idx = cols[:STREAM_EVENT_CHUNK]
        out["gather_ms"] = {
            "index": time_ms(lambda: wide[idx], 5),
            "index_select": time_ms(lambda: wide.index_select(0, idx), 5)}
        log(f"  row gather at one chunk (ms): {json.dumps(out['gather_ms'])}")
    del wide, tall

    # ---- the kernel at this shape, with its baselines
    chunk = plan_user_chunks(n_users, n_items)[0][1]
    out["kernel"] = {
        "users": n_users, "items": n_items, "rank": RANK,
        "launches": out["launches"]["main"],
        "ms": time_ms(lambda: fused_score_topk(
            proj, panel, bits, TOPK, n_valid_cols=n_items), 10)
        if on_card else None,
        "plain_ms": time_ms(lambda: fused_score_topk_reference(
            proj_head, panel, bits_head, TOPK, n_valid_cols=n_items), 3)
        if on_card else None,
        "plain_users": VERIFY_USERS, "chunk_users": chunk,
        "max_abs_err": out["max_abs_err"],
        "flop": 2 * n_users * n_items * RANK,
        "bytes": 4 * (proj.numel() + n_items * RANK + bits.numel()
                      + 2 * n_users * TOPK)}
    proj_c, bits_c = proj[:chunk], bits[:chunk]

    def topk_route():
        scores = proj_c @ panel.T
        scores.masked_fill_(seen_mask(bits_c, n_items), -torch.inf)
        return torch.topk(scores, TOPK, dim=1)

    if on_card:
        out["kernel"]["library_ms"] = time_ms(lambda: proj_c @ panel.T, 5)
        out["kernel"]["topk_ms"] = time_ms(topk_route, 3)
        out["kernel"].update(split_fields(proj, panel, bits, n_items,
                                          reps=5))
    log(f"  kernel at {n_users} x {n_items} x {RANK}: "
        f"{json.dumps(out['kernel'])}")

    # ---- exact f64 factors (Gram over dense row blocks), scored through
    # the port-budget operator so only the factors differ
    with Timer() as t:
        v_exact, s_exact = exact_item_factors(rows, cols, vals, n_users,
                                              n_items, RANK)
    out["exact_factor_s"] = t.seconds
    v_ex = v_exact.float().contiguous()
    proj_ex = ops["split_port"].mm(v_ex)
    before = fused_score_topk.launches
    recs_ex = perm[fused_score_topk(proj_ex, v_ex.index_select(0, perm),
                                    bits, TOPK, n_valid_cols=n_items
                                    ).long()]
    out["launches"]["exact"] = fused_score_topk.launches - before
    metrics("exact", recs_ex)
    del proj_ex
    ex = out["metrics"]["exact"]
    for name in ops:
        got = out["metrics"][name]
        delta = max(abs(got["hr"] - ex["hr"]), abs(got["ndcg"] - ex["ndcg"]))
        overlap = _overlap(recs[name], recs_ex)
        out.setdefault("metric_delta_vs_exact", {})[name] = delta
        out.setdefault("top10_overlap", {})[name] = overlap
        out.setdefault("sv_max_rel_err", {})[name] = (
            (results[name].s.double() - s_exact).abs() / s_exact).max().item()
        check(delta < 1e-3, f"{name}: metric delta vs exact f64 factors "
              f"{delta:.2e} < 1e-3")
        check(overlap >= 0.98, f"{name}: top-{TOPK} overlap vs exact "
              f"{overlap:.5f} >= 0.98")
    del v_exact, v_ex, recs_ex

    # ---- the mesh tier: distributed_chunked_rsvd on (4, 1), one card,
    # against the single-device build of the same solver over the 2 GiB
    # split operator (same start, same steps)
    single_split = ops["split_jax"]
    for name in ("split_port", "tiled"):
        del ops[name]
    del results, recs, proj, panel
    if on_card:
        torch.cuda.empty_cache()
    mesh41 = make_mesh(devices=mesh_devices(4, device), shape=(4, 1))
    fused_score_topk.launches = 0
    with Timer() as t:
        meshed = dist_module.distributed_chunked_rsvd(
            rows, cols, vals, shape, RANK, mesh41, n_iter=MESH_ITERS, seed=0,
            split_head=True, head_budget_gb=JAX_HEAD_GB)
    out["mesh_build_s"] = t.seconds
    with Timer() as t:
        single = randomized_svd(single_split, RANK, n_iter=MESH_ITERS,
                                tol=None, seed=0, qr_method="cholesky2")
    out["mesh_single_build_s"] = t.seconds
    recs_mesh = score_all(*meshed)[0]
    recs_single = score_all(*single)[0]
    out["launches"]["mesh"] = fused_score_topk.launches
    metrics("mesh", recs_mesh)
    metrics("mesh_single", recs_single)
    out["mesh_overlap"] = _overlap(recs_mesh, recs_single)
    out["mesh_hr_delta"] = abs(out["metrics"]["mesh"]["hr"]
                               - out["metrics"]["mesh_single"]["hr"])
    check(out["mesh_overlap"] >= 0.99 and out["mesh_hr_delta"] <= 1e-3,
          f"distributed_chunked_rsvd (4, 1) vs the single-device split "
          f"build: top-{TOPK} overlap {out['mesh_overlap']:.5f} >= 0.99, "
          f"|dHR@{TOPK}| {out['mesh_hr_delta']:.2e} <= 1e-3")
    del single_split, ops, meshed, single, recs_mesh, recs_single

    # ---- ImplicitALS past the budget: (4, 1) mesh vs one device
    frame = events_frame(*make_realistic_coo_device(**ials_geometry, seed=0,
                                                    device=device))
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.warm_start = False
    data.holdout_size = 1
    data.prepare()
    del frame
    calls = []
    banded = dist_module.distributed_ials_events
    saved = config.get_default("hbm_score_budget_gb")
    config.set_default("hbm_score_budget_gb", ials_budget_gb)
    dist_module.distributed_ials_events = (
        lambda *a, **k: calls.append(1) or banded(*a, **k))
    ials = {}
    try:
        for name, mesh in (("ials_mesh", mesh41), ("ials_single", None)):
            model = ImplicitALS(data, device=device, mesh=mesh)
            model.verbose = False
            model.rank = RANK
            with Timer() as t:
                model.build()
            out["build_s"][name] = t.seconds
            before = fused_score_topk.launches
            table = model.evaluate()
            out["launches"][name] = fused_score_topk.launches - before
            out["metrics"][name] = {f: float(getattr(m, f)) for m in table
                                    for f in m._fields
                                    if getattr(m, f) is not None}
            ials[name] = model.factors["movieid"]
    finally:
        dist_module.distributed_ials_events = banded
        config.set_default("hbm_score_budget_gb", saved)
    check(calls == [1], "ImplicitALS(mesh=(4, 1)) past the budget took "
          "distributed_ials_events")
    out["ials_item_rel_diff"] = (torch.linalg.norm(
        ials["ials_mesh"] - ials["ials_single"])
        / torch.linalg.norm(ials["ials_single"])).item()
    out["ials_hr_delta"] = abs(out["metrics"]["ials_mesh"]["hr"]
                               - out["metrics"]["ials_single"]["hr"])
    log(f"  iALS past the budget: mesh {out['build_s']['ials_mesh']:.2f} s, "
        f"one device {out['build_s']['ials_single']:.2f} s")
    check(out["ials_item_rel_diff"] <= 1e-4 and out["ials_hr_delta"] <= 2e-3,
          f"distributed_ials_events (4, 1) vs ials_train_events: item "
          f"factors {out['ials_item_rel_diff']:.2e} <= 1e-4 relative, "
          f"|dHR@{TOPK}| {out['ials_hr_delta']:.2e} <= 2e-3")
    del data, ials, model

    # ---- the dense route, timing only: the 34.1 GB block on the card
    if on_card:
        gc.collect()
        torch.cuda.empty_cache()
    with Timer() as t:
        dense = torch.zeros(shape, dtype=torch.float32, device=rows.device)
        dense.index_put_((rows, cols), vals, accumulate=True)
    out["dense_staging_s"] = t.seconds
    out["dense_gb"] = dense.numel() * 4 / 1e9
    for key in ("dense_build_s", "dense_build_warm_s"):
        with Timer() as t:
            build(dense_operator(dense))
        out[key] = t.seconds
    log(f"  dense route: {out['dense_gb']:.1f} GB block in "
        f"{out['dense_staging_s']:.2f} s, Krylov build "
        f"{out['dense_build_s']:.3f} / {out['dense_build_warm_s']:.3f} s")
    del dense
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None)
    out["phase_s"] = wall() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 12: the evaluation protocols
# --------------------------------------------------------------------------

HEAD_FEEDBACK_FRAC = 0.33    # LongTailMixin's default short head
N_UNSEEN = 999               # EigenRec's sampled candidates per user
EIGENREC_SCALINGS = (1.0, 0.5)
NEAR_TIE_RTOL = 1e-5         # registered ranks: near-tied users excluded


def protocol_classes():
    """Phase 12's data and model classes: the port's protocol mixins over
    its data model and SVD models."""
    from types import SimpleNamespace
    from polara_tpu_torch.data import (ItemPostFilteringData, LongTailMixin,
                                       RecommenderData,
                                       SampledEvaluationMixin)
    from polara_tpu_torch.models import (ItemPostFilteringMixin, ScaledSVD,
                                         SVDModel)
    from polara_tpu_torch.models.sampled import SampledEvaluationSVDMixin

    class LongTailSampledData(SampledEvaluationMixin, LongTailMixin,
                              RecommenderData):
        pass

    class SampledData(SampledEvaluationMixin, RecommenderData):
        pass

    class SampledSVD(SampledEvaluationSVDMixin, SVDModel):
        pass

    class SampledScaledSVD(SampledEvaluationSVDMixin, ScaledSVD):
        pass

    class ContextualSVD(ItemPostFilteringMixin, SVDModel):
        pass

    return SimpleNamespace(
        LongTailSampledData=LongTailSampledData, SampledData=SampledData,
        ItemPostFilteringData=ItemPostFilteringData, SVDModel=SVDModel,
        SampledSVD=SampledSVD, SampledScaledSVD=SampledScaledSVD,
        ContextualSVD=ContextualSVD)


def short_head_boundary(items: np.ndarray, frac: float):
    """Item counts of the log and the count of its first long-tail item
    recomputed in numpy: items in descending count order, the tail starts
    where the cumulative share passes ``frac``.  Items counted above that
    count are short head in every tie order."""
    counts = np.bincount(items)
    ordered = np.sort(counts)[::-1]
    share = np.cumsum(ordered) / ordered.sum()
    return counts, int(ordered[np.searchsorted(share, frac, side="right")])


def seen_mask(n_rows, n_items, parts, device):
    """(rows x items) bool mask on the card of the given (row, col) pairs."""
    import torch
    mask = torch.zeros((n_rows, n_items), dtype=torch.bool, device=device)
    for rows, cols in parts:
        mask[torch.as_tensor(np.array(rows, np.int64), device=device),
             torch.as_tensor(np.array(cols, np.int64), device=device)] = True
    return mask


def long_tail_part(geometry, device, classes, out):
    """Phase 12 (a): PureSVD on the long-tail holdout at ``geometry``,
    scored through the kernel.  Returns the data and the model."""
    import torch
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.models import PopularityModel
    from polara_tpu_torch.ops.fused_topk import fused_score_topk

    frame = events_frame(*make_realistic_coo_device(**geometry, seed=0,
                                                    device=device))
    t0 = wall()
    data = classes.LongTailSampledData(
        frame, "userid", "movieid", "rating", seed=0, verbose=False,
        long_tail_holdout=True, head_feedback_frac=HEAD_FEEDBACK_FRAC)
    data.warm_start = False
    data.test_ratio = 0.2
    data.holdout_size = 1
    data.prepare()
    out["prepare_s"] = wall() - t0
    out["holdout_path"] = data.holdout_path
    hold = data.test.holdout
    n_items = len(data.get_entity_index("movieid"))
    out["test_users"] = len(hold)
    item_old = data.get_entity_index("movieid").set_index("new")["old"]
    counts, boundary = short_head_boundary(frame["movieid"].to_numpy(),
                                           HEAD_FEEDBACK_FRAC)
    held = counts[item_old.loc[hold["movieid"]].to_numpy()]
    out["short_head_items"] = int((counts > boundary).sum())
    out["boundary_count"] = boundary
    check(bool((held <= boundary).all()),
          f"all {len(hold)} holdout items lie outside the short head "
          f"({out['short_head_items']} items above {boundary} events, "
          f"recomputed in numpy from the log)")
    log(f"  long tail: prepare() {out['prepare_s']:.2f} s "
        f"({data.holdout_path} holdout path), {len(hold)} test users")

    svd = classes.SVDModel(data, device=device)
    svd.verbose = False
    svd.rank = RANK
    t0 = wall()
    svd.build()
    out["build_s"] = wall() - t0
    fused_score_topk.launches = 0
    t0 = wall()
    recs = svd._device_recommendations()
    out["scoring_s"] = wall() - t0
    scores = svd.evaluate(["relevance", "ranking"])
    out["launches"] = fused_score_topk.launches
    with Timer() as t:
        svd.get_recommendations()
    out["scoring_warm_ms"] = t.seconds * 1e3
    svd.verify_integrity = False     # the host's check of the frames
    with Timer() as t:
        svd.get_recommendations()
    out["scoring_warm_unverified_ms"] = t.seconds * 1e3
    svd.verify_integrity = True
    out["hr10"], out["mrr10"] = float(scores[0].hr), float(scores[1].mrr)
    check(out["launches"] > 0, f"the long-tail PureSVD launched the kernel "
          f"({out['launches']}x)")
    check(bool(((recs >= 0) & (recs < n_items)).all()),
          "long-tail ids in range")
    plan, params = svd._test_plan, svd.score_params()
    proj = classes.SVDModel.proj_chunk(params, plan.chunks[0])
    out["fused_gap"] = _fused_gap(plan, proj, params["item_panel"], recs,
                                  n_items)
    check(out["fused_gap"] < 1e-3, f"long-tail fused_ok: re-scored gap "
          f"{out['fused_gap']:.2e} < 1e-3")
    pop = PopularityModel(data, device=device)
    pop.verbose = False
    out["popularity_hr10"] = float(pop.evaluate("relevance").hr)
    check(out["hr10"] > out["popularity_hr10"],
          f"long-tail HR@{TOPK} {out['hr10']:.5f} > popularity's "
          f"{out['popularity_hr10']:.5f}")
    log(f"  long-tail PureSVD-{RANK}: build {out['build_s']:.3f} s, scoring "
        f"{out['scoring_s']:.3f} s (warm {out['scoring_warm_ms']:.2f} ms, "
        f"{out['scoring_warm_unverified_ms']:.2f} ms without the integrity "
        f"check), "
        f"HR@{TOPK} {out['hr10']:.5f} MRR@{TOPK} {out['mrr10']:.5f}")
    del recs, proj, pop
    return data, svd


def sampled_part(data, svd, device, classes, out):
    """Phase 12 (b): the sampled-candidate protocol on (a)'s split and
    factors, by registered lists and by on-the-fly samples."""
    import pandas as pd
    import torch
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.ops.samplers import (sample_row_wise,
                                               sampled_scores)
    from polara_tpu_torch.ops.sparse import (inner_product_at,
                                             sorted_rows_matmul)
    from polara_tpu_torch.runtime.rng import generator_from_seed

    model = classes.SampledSVD(data, device=device)
    model.verbose = False
    model.rank = RANK
    model.set_factors(svd.factors)
    hold = data.test.holdout
    (rows, cols, fb), (n_test, n_items), test_users = model._get_test_data()
    check(np.array_equal(hold["userid"].to_numpy(), test_users),
          "holdout rows align with the fold-in's test rows")
    hold_rows = np.arange(n_test)
    hold_items = hold["movieid"].to_numpy()
    train = data.training
    in_test = train["userid"].isin(test_users).to_numpy()
    train_rows = np.searchsorted(test_users,
                                 train["userid"].to_numpy()[in_test])
    seen = seen_mask(n_test, n_items, [
        (rows, cols), (hold_rows, hold_items),
        (train_rows, train["movieid"].to_numpy()[in_test])], device)

    def clean(items, what):
        sorted_items = torch.sort(items.long(), 1).values
        check(not bool(seen.gather(1, items.long()).any())
              and bool((sorted_items[:, 1:] != sorted_items[:, :-1]).all()),
              f"{what}: no sampled item is in a user's training profile, "
              f"test profile or holdout, and no row repeats an item "
              f"({n_test} users x {items.shape[1]}, checked on the card)")

    # ---- registered lists from sample_row_wise, seeded apart from the
    # data's seed (the on-the-fly route's), so the two routes are two
    # independent samples of the protocol
    t0 = wall()
    lists = sample_row_wise(np.concatenate([rows, hold_rows]),
                            np.concatenate([cols, hold_items]), n_test,
                            n_items, N_UNSEEN, seed=data.seed + 1,
                            device=device)
    out["sample_row_wise_s"] = wall() - t0
    lists_d = torch.as_tensor(lists, device=device)
    clean(lists_d, "sample_row_wise")
    data.set_unseen_interactions(pd.Series(list(lists), index=test_users),
                                 reindex=False)
    model.topk = N_UNSEEN + 1
    fused_score_topk.launches = 0
    t0 = wall()
    recs = model._device_recommendations()
    out["registered_scoring_s"] = wall() - t0
    out["registered_mrr10"] = float(model.evaluate("ranking", topk=TOPK).mrr)
    out["launches"] = fused_score_topk.launches
    rank = (recs == 0).int().argmax(1)
    # the holdout's rank against the f64 count of candidates above it
    v64 = model.factors["movieid"].double()
    p64 = sorted_rows_matmul(
        torch.as_tensor(rows, device=device).long(),
        torch.as_tensor(cols, device=device).long(),
        torch.as_tensor(np.asarray(fb, np.float64), device=device), v64,
        n_test)
    users = torch.arange(n_test, device=device)[:, None]
    hold64 = inner_product_at(p64, v64, users,
                              torch.as_tensor(np.array(hold_items), device=device
                                              )[:, None])
    cand64 = inner_product_at(p64, v64, users, lists_d)
    near = ((cand64 - hold64).abs()
            <= NEAR_TIE_RTOL * hold64.abs()).any(1)
    above = (cand64 > hold64).sum(1)
    out["near_tie_users"] = int(near.sum())
    out["registered_full_mrr"] = (1.0 / (rank.double() + 1)).mean().item()
    check(bool((rank == above)[~near].all()),
          f"registered route: every user's holdout rank equals the f64 "
          f"count of candidates above it ({out['near_tie_users']} users "
          f"with a candidate within {NEAR_TIE_RTOL} relative excluded)")
    uf, vf, pairs = model._test_user_factors()
    ui = torch.arange(n_test)[:, None]
    out["inner_product_at_ms"] = time_ms(
        lambda: inner_product_at(uf, vf, ui, lists_d), 3)
    del cand64, hold64, p64, v64, recs

    # ---- on-the-fly samples from the data's seed
    data.unseen_interactions = None
    data.unseen_items_num = N_UNSEEN
    model._recommendations = None
    t0 = wall()
    model._device_recommendations()
    out["on_the_fly_scoring_s"] = wall() - t0
    out["on_the_fly_mrr10"] = float(model.evaluate("ranking",
                                                   topk=TOPK).mrr)
    out["launches"] += fused_score_topk.launches
    uf2, _, _ = model._test_user_factors()
    check(torch.equal(uf, uf2), "two fold-ins give identical bits")
    first = model.compute_random_item_scores_gen(uf, vf, pairs, N_UNSEEN)
    with Timer() as t:
        second = model.compute_random_item_scores_gen(uf, vf, pairs,
                                                      N_UNSEEN)
    out["sampled_scores_ms"] = t.seconds * 1e3
    check(torch.equal(first, second),
          "two on-the-fly runs from the same seed give identical scores")
    seen_rows = np.concatenate([pairs[0], hold_rows])
    seen_cols = np.concatenate([pairs[1], hold_items])
    again, items = sampled_scores(
        uf, vf, torch.as_tensor(seen_rows), torch.as_tensor(seen_cols),
        torch.ones(len(seen_rows), dtype=torch.bool),
        generator_from_seed(data.seed, device), N_UNSEEN, return_items=True)
    check(torch.equal(again, first), "sampled_scores with return_items "
          "draws the model's candidates")
    clean(items, "sampled_scores")
    out["mrr_gap"] = abs(out["registered_mrr10"] - out["on_the_fly_mrr10"])
    check(out["mrr_gap"] < 0.03, f"registered MRR@{TOPK} "
          f"{out['registered_mrr10']:.5f} and on-the-fly "
          f"{out['on_the_fly_mrr10']:.5f} agree within 0.03")
    check(out["launches"] == 0, "the sampled protocol took no kernel "
          "launch (candidates differ per user)")
    log(f"  sampled: sample_row_wise {out['sample_row_wise_s']:.3f} s, "
        f"inner_product_at {out['inner_product_at_ms']:.2f} ms, one "
        f"sampled_scores {out['sampled_scores_ms']:.2f} ms; MRR@{TOPK} "
        f"registered {out['registered_mrr10']:.5f}, on the fly "
        f"{out['on_the_fly_mrr10']:.5f}")
    del seen, lists_d, first, second, again, items


def write_movielens_zip(path, events, movies):
    """``ml-1m.zip`` in MovieLens's legacy layout: ``ml-1m/ratings.dat``
    (``UserID::MovieID::Rating::Timestamp``) and ``ml-1m/movies.dat``
    (``MovieID::Title::Genres``)."""
    import io
    import zipfile
    table = np.stack([events["userid"].to_numpy(),
                      events["movieid"].to_numpy(),
                      events["rating"].to_numpy(),
                      956_703_932 + np.arange(len(events))], 1)
    ratings = io.BytesIO()
    np.savetxt(ratings, table, fmt="%d::%d::%d::%d")
    lines = (movies["movieid"].astype(str) + "::" + movies["movienm"]
             + "::" + movies["genres"])
    with zipfile.ZipFile(path, "w") as zf:
        zf.writestr("ml-1m/ratings.dat", ratings.getvalue())
        zf.writestr("ml-1m/movies.dat", "\n".join(lines) + "\n")


def movielens_part(geometry, device, classes, out):
    """Phase 12 (c): ML-1M geometry through the MovieLens loader, the
    EigenRec protocol at its published configuration, and contextual
    post-filtering by genre."""
    import os
    import tempfile
    import torch
    from polara_tpu_torch.datasets import (get_movielens_data,
                                           get_split_genres,
                                           make_realistic_interactions)
    from polara_tpu_torch.ops.fused_topk import fused_score_topk
    from polara_tpu_torch.ops.scoring import run_scores_only
    from polara_tpu_torch.preprocessing.dataframes import \
        sample_unseen_interactions

    events = make_realistic_interactions(**geometry, seed=0)
    movies = synthetic_movies(np.sort(events["movieid"].unique()))
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ml-1m.zip")
        write_movielens_zip(path, events, movies)
        t0 = time.perf_counter()
        ratings, genres = get_movielens_data(local_file=path,
                                             get_genres=True)
        out["loader_read_s"] = time.perf_counter() - t0
    check(all(np.array_equal(ratings[c].to_numpy(), events[c].to_numpy())
              for c in ("userid", "movieid", "rating"))
          and genres.equals(get_split_genres(movies)),
          f"get_movielens_data reads back the {len(ratings)} ratings and "
          f"{len(genres)} genre rows written")

    # ---- EigenRec (benchmarks/quality_ml1m.py:153-213)
    data = classes.SampledData(ratings.copy(), "userid", "movieid",
                               "rating", seed=0, verbose=False)
    data.warm_start = False
    data.test_ratio = 0
    data.holdout_size = 1
    data.random_holdout = True
    data.prepare()
    data.set_test_data(holdout=data.test.holdout.query("rating == 5"),
                       warm_start=False, reindex=False,
                       ensure_consistency=False, holdout_size=1)
    item_pool = data.get_entity_index("movieid")["old"].values
    t0 = time.perf_counter()
    unseen = sample_unseen_interactions(ratings, item_pool,
                                        n_random=N_UNSEEN, random_state=0,
                                        userid="userid", itemid="movieid")
    out["sample_unseen_s"] = time.perf_counter() - t0
    data.set_unseen_interactions(unseen, reindex=True)
    check(data.unseen_items_num == N_UNSEEN
          and bool(data.unseen_interactions.apply(len).eq(N_UNSEEN).all()),
          f"{N_UNSEEN} unseen items registered per user")
    out["eigenrec_users"] = int(data.test.holdout["userid"].nunique())
    out["eigenrec_mrr"] = {}
    for scaling in EIGENREC_SCALINGS:
        model = classes.SampledScaledSVD(data, device=device)
        model.verbose = False
        model.rank = RANK
        model.col_scaling = scaling
        mrr = float(model.evaluate("ranking", simple_rates=True).mrr)
        out["eigenrec_mrr"][str(scaling)] = mrr
        check(np.isfinite(mrr) and 0 < mrr <= 1,
              f"EigenRec col_scaling {scaling}: MRR {mrr:.5f} in (0, 1]")
    out["eigenrec_scaling_improves"] = (out["eigenrec_mrr"]["0.5"]
                                        > out["eigenrec_mrr"]["1.0"])
    log(f"  EigenRec at ML-1M geometry ({out['eigenrec_users']} 5-star "
        f"holdouts x {N_UNSEEN} candidates): MRR {out['eigenrec_mrr']}; "
        f"col_scaling 0.5 beats 1.0: {out['eigenrec_scaling_improves']} "
        f"(recorded, not gated)")
    del data, model

    # ---- contextual post-filtering by genre
    first = movies.set_index("movieid")["genres"].str.split("|").str[0]
    frame = ratings.assign(genre=first.loc[ratings["movieid"]].to_numpy())
    mapping = genres.rename(columns={"genreid": "genre"})[["movieid",
                                                           "genre"]]
    t0 = time.perf_counter()
    data = classes.ItemPostFilteringData(
        frame, "userid", "movieid", "rating",
        item_context_mapping={"genre": mapping}, seed=0, verbose=False)
    data.warm_start = False
    data.test_ratio = 0.2
    data.holdout_size = 1
    data.prepare()
    out["contextual_prepare_s"] = time.perf_counter() - t0
    models = {}
    for name, cls in (("plain", classes.SVDModel),
                      ("contextual", classes.ContextualSVD)):
        model = models[name] = cls(data, device=device)
        model.verbose = False
        model.rank = RANK
        model.build()
        fused_score_topk.launches = 0
        out[f"{name}_hr10"] = float(model.evaluate("relevance").hr)
        out[f"{name}_launches"] = fused_score_topk.launches
        with Timer() as t:
            model.get_recommendations()
        out[f"{name}_scoring_warm_ms"] = t.seconds * 1e3
    t0 = time.perf_counter()
    data.upvote_arrays()
    out["upvote_arrays_ms"] = (time.perf_counter() - t0) * 1e3
    check(out["plain_launches"] > 0 and out["contextual_launches"] == 0,
          f"the plain SVD launched the kernel ({out['plain_launches']}x), "
          f"the contextual one none ({out['contextual_launches']}x)")
    model = models["contextual"]
    check(not model.uses_fused_scoring(model.score_params()),
          "the contextual model routes to the unfused path")
    recs = model._device_recommendations().long()
    n_test, n_items = recs.shape[0], len(data.get_entity_index("movieid"))
    check(bool(((recs >= 0) & (recs < n_items)).all()),
          "contextual ids in range")
    items, valid = data.upvote_arrays()
    row_ids = np.broadcast_to(np.arange(n_test)[:, None], items.shape)
    upvoted = seen_mask(n_test, n_items, [(row_ids[valid], items[valid])],
                        device)
    (rows, cols, _), _, _ = model._get_test_data()
    seen = seen_mask(n_test, n_items, [(rows, cols)], device)
    scores = torch.as_tensor(run_scores_only(
        model._test_plan, classes.SVDModel.score_chunk,
        model.score_params()), device=device)
    lead = torch.clamp((upvoted & ~seen).sum(1), max=TOPK)
    in_lead = torch.arange(TOPK, device=device)[None, :] < lead[:, None]
    picked = scores.gather(1, recs)
    tol = 4 * 2.0 ** -23 * (2 * scores.abs().max() + 1)
    check(bool((upvoted.gather(1, recs) | ~in_lead).all()),
          "the first min(10, unseen upvoted) picks are upvoted items")
    check(bool(((picked[:, 1:] <= picked[:, :-1] + tol)
                | ~in_lead[:, 1:]).all()),
          "upvoted picks come in descending order of their unboosted "
          "scores (ties within 4 ulp of the boosted scale aside)")
    check(not bool(seen.gather(1, recs).any()), "no seen item is picked")
    check(out["contextual_hr10"] > out["plain_hr10"],
          f"contextual HR@{TOPK} {out['contextual_hr10']:.5f} > the plain "
          f"model's {out['plain_hr10']:.5f}")
    log(f"  contextual: HR@{TOPK} {out['contextual_hr10']:.5f} vs plain "
        f"{out['plain_hr10']:.5f}; warm scoring unfused "
        f"{out['contextual_scoring_warm_ms']:.2f} ms (upvote_arrays "
        f"{out['upvote_arrays_ms']:.2f} ms on the host) vs fused "
        f"{out['plain_scoring_warm_ms']:.2f} ms")


def protocols_phase(geometry, small_geometry, device="cuda"):
    """Phase 12: the long-tail holdout at ``geometry`` (PureSVD through the
    kernel), the sampled-candidate protocol on its split and factors, and,
    at ``small_geometry`` through the MovieLens loader, EigenRec and
    contextual post-filtering.  Returns the measured fields; raises on a
    failed gate except the launch counts the caller checks."""
    import torch
    t_phase = wall()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    classes = protocol_classes()
    out = {"long_tail": {}, "sampled": {}, "movielens": {}}
    data, svd = long_tail_part(geometry, device, classes, out["long_tail"])
    sampled_part(data, svd, device, classes, out["sampled"])
    del data, svd
    gc.collect()
    movielens_part(small_geometry, device, classes, out["movielens"])
    out["launches"] = {"long_tail": out["long_tail"]["launches"],
                       "sampled": out["sampled"]["launches"],
                       "contextual_plain": out["movielens"]["plain_launches"],
                       "contextual": out["movielens"]["contextual_launches"]}
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None)
    out["phase_s"] = wall() - t_phase
    return out


# --------------------------------------------------------------------------
# phase 13: the fused kernel past rank 256, and MyMediaLite's adapter
# --------------------------------------------------------------------------

C5_RANK = 300                # past the kernel's whole-rank staging (256)
C5_SWEEP_RANKS = (250, 300)  # the sweep pads 250 up to 300
MML_WRMF_RANK = 50           # carries phase 3's PureSVD-50 factors
MML_BPR_RANK = 256           # + the bias column: 257 columns after the QR

# The stand-in for MyMediaLite's ``item_recommendation`` (the card has no
# MyMediaLite and no network), in the manner of tests/_fake_mml.py: it
# takes the wrapper's exact command line, reads the training CSV for the
# ids, and writes the factors saved beside it (``factors.npz``, rows by
# framework id) in MyMediaLite's text layout, with the id mappings in
# reversed order.  Bias models follow the layout with biases.  Values are
# written with 9 significant digits, which gives every f32 back exactly.
MML_STAND_IN = r'''
import os
import sys

import numpy as np
import pandas as pd

BLOCK = 1 << 21


def digits(out, col, width, x):
    for j in range(width):
        out[:, col + width - 1 - j] = 48 + (x // 10 ** j) % 10


def decimal(vals):
    """'+mmmmmmmmme+ee': 9 significant digits of each value."""
    v = np.asarray(vals, np.float64)
    a = np.abs(v)
    e = np.zeros(len(v), np.int64)
    nz = a > 0
    e[nz] = np.floor(np.log10(a[nz])).astype(np.int64) - 8
    m = np.rint(a / 10.0 ** e).astype(np.int64)
    for fix, step in ((m >= 10 ** 9, 1), (nz & (m < 10 ** 8), -1)):
        e[fix] += step
        m[fix] = np.rint(a[fix] / 10.0 ** e[fix]).astype(np.int64)
    out = np.empty((len(v), 14), np.uint8)
    out[:, 0] = np.where(v < 0, ord("-"), ord("+"))
    digits(out, 1, 9, m)
    out[:, 10] = ord("e")
    out[:, 11] = np.where(e < 0, ord("-"), ord("+"))
    digits(out, 12, 2, np.abs(e))
    return out


def write_factors(handle, factors):
    """'i f value' rows, entity by entity (ids in internal order)."""
    n, nf = factors.shape
    width = len(str(max(n - 1, 0)))
    for lo in range(0, n * nf, BLOCK):
        flat = np.arange(lo, min(lo + BLOCK, n * nf))
        out = np.empty((len(flat), width + 21), np.uint8)
        digits(out, 0, width, flat // nf)
        out[:, width] = 32
        digits(out, width + 1, 4, flat % nf)
        out[:, width + 5] = 32
        out[:, width + 6:width + 20] = decimal(factors.reshape(-1)[flat])
        out[:, -1] = 10
        handle.write(out.tobytes())


def write_values(handle, vals):
    out = np.empty((len(vals), 15), np.uint8)
    out[:, :14] = decimal(vals)
    out[:, 14] = 10
    handle.write(out.tobytes())


args = {}
for arg in sys.argv[1:]:
    if arg.startswith("--") and "=" in arg:
        key, _, value = arg[2:].partition("=")
        args[key] = value
    else:
        args[arg.lstrip("-")] = True
nf = 10
for opt in args.get("recommender-options", "").strip('"').split():
    key, _, value = opt.partition("=")
    if key == "num_factors":
        nf = int(value)
algo = args["recommender"]
saved = np.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "factors.npz"))
user, item = saved["user"], saved["item"]
bias = saved["bias"] if "bias" in saved.files else None
if user.shape[1] != nf or item.shape[1] != nf:
    sys.exit(f"num_factors={nf}, saved factors {user.shape}/{item.shape}")
if "no-id-mapping" in args:
    users, items = np.arange(len(user)), np.arange(len(item))
else:
    train = pd.read_csv(args["training-file"], header=None, usecols=[0, 1])
    users = np.unique(train[0].to_numpy())[::-1]
    items = np.unique(train[1].to_numpy())[::-1]
    for key, ids in (("save-user-mapping", users),
                     ("save-item-mapping", items)):
        np.savetxt(args[key], np.column_stack([np.arange(len(ids)), ids]),
                   fmt="%d\t%d")
with open(args["save-model"], "wb") as handle:
    handle.write(f"0.11\n{algo} stand-in\n{len(users)} {nf}\n".encode())
    write_factors(handle, user[users])
    if bias is not None:
        handle.write(f"{len(items)}\n".encode())
        write_values(handle, bias[items])
    handle.write(f"{len(items)} {nf}\n".encode())
    write_factors(handle, item[items])
'''


def write_mml_stand_in(library_dir, user, item, bias=None) -> None:
    """The stand-in executable as ``library_dir/item_recommendation`` and
    the factors it will write (rows by framework id) beside it."""
    import os
    import stat
    from pathlib import Path

    from polara_tpu_torch.models.external.mymedialite import PROGRAM
    arrays = {"user": user, "item": item}
    if bias is not None:
        arrays["bias"] = bias
    np.savez(Path(library_dir) / "factors.npz", **arrays)
    program = Path(library_dir) / PROGRAM
    program.write_text(f"#!{sys.executable}\n{MML_STAND_IN}")
    os.chmod(program, os.stat(program).st_mode | stat.S_IXUSR)


def phase3_data_model(geometry, device):
    """Phase 3's data and split through the data model: the training
    events as its frame, each user's held-out event as the holdout (known
    users, every user tested)."""
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    rows, cols, vals = (x.cpu().numpy() for x in make_realistic_coo_device(
        **geometry, seed=0, device=device))
    _, _, hold_mask = holdout_split(rows, cols)
    keep = ~hold_mask
    data = RecommenderData(events_frame(rows[keep], cols[keep], vals[keep]),
                           "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.prepare_training_only()
    data.set_test_data(holdout=events_frame(rows[hold_mask], cols[hold_mask],
                                            vals[hold_mask]),
                       warm_start=False)
    data.name = "ml10m_geometry"
    return data


def path_plain_picks(model, users):
    """The plain version of the model's fused route for its first
    ``users`` test users: ``fused_score_topk_reference`` over the panel in
    the route's item order (``fused_item_order``), ids mapped back."""
    import torch
    from polara_tpu_torch import config
    from polara_tpu_torch.ops.fused_topk import fused_score_topk_reference
    params = model.score_params()
    panel = params["item_panel"]
    plan = model._test_plan
    n_items = panel.shape[0]
    proj = type(model).proj_chunk(params, plan.chunks[0])[:users]
    if config.get_default("fused_item_order") == "popularity":
        perm, inv = plan.pop_order(n_items)
        lookup = torch.as_tensor(perm, device=panel.device)
        bits = plan.seen_bits(0, n_items, col_map=inv,
                              map_token=("pop", n_items))
        plain = fused_score_topk_reference(proj, panel.index_select(
            0, lookup), bits[:users], TOPK, n_valid_cols=n_items)
        return torch.where(plain >= 0, lookup[plain.long().clamp(min=0)],
                           plain.long())
    bits = plan.seen_bits(0, n_items)
    return fused_score_topk_reference(proj, panel, bits[:users], TOPK,
                                      n_valid_cols=n_items).long()


def fused_ok_exact(model, name, out, verify_users=VERIFY_USERS):
    """``fused_ok`` held bit for bit: the model's picks for its first test
    users equal the plain version's."""
    import torch
    users = min(verify_users, len(model._test_users))
    recs = model._device_recommendations()[:users].long()
    plain = path_plain_picks(model, users)
    out["fused_exact_agreement"][name] = (recs == plain).float().mean().item()
    check(torch.equal(recs, plain), f"{name} fused_ok: the picks of "
          f"{users} users are the plain version's, bit for bit")


def sliced_variant_ms(proj, panel, bits, n_valid, reps=5):
    """Warm ms of the C entry point at these inputs (rank > 256: the
    sliced ring) in the library the port loads (``full``) and in each of
    ``PHASE_VARIANTS`` and ``SLICED_VARIANTS``, in turns full, variants,
    variants reversed, full; those of ``EXACT_VARIANTS`` must return the
    kernel's ids and values."""
    import torch
    from polara_tpu_torch.ops._cuda_build import load_library
    from polara_tpu_torch.ops.fused_topk import (fused_score_topk,
                                                 panel_columns, proj_columns)
    n_users, rank = proj.shape
    device = proj.device
    vals = torch.empty((n_users, TOPK), dtype=torch.float32, device=device)
    idx = torch.empty((n_users, TOPK), dtype=torch.int32, device=device)
    items_t = torch.empty((rank, panel_columns(n_valid, rank)),
                          dtype=torch.float32, device=device)
    proj_t = torch.empty((rank, proj_columns(n_users)), dtype=torch.float32,
                         device=device)
    stream = torch.cuda.current_stream().cuda_stream
    variants = {**PHASE_VARIANTS, **SLICED_VARIANTS}
    libs = {"full": load_library()}
    libs.update({name: load_library(defines)
                 for name, defines in variants.items()})

    def call(lib):
        err = lib.polara_fused_score_topk(
            proj.data_ptr(), panel.data_ptr(), items_t.data_ptr(),
            proj_t.data_ptr(), bits.data_ptr(), vals.data_ptr(),
            idx.data_ptr(), None, None, n_users, panel.shape[0], rank,
            bits.shape[1], n_valid, TOPK, 1, 1, stream)
        if err:
            raise RuntimeError(f"kernel variant failed: cudaError_t {err}")

    want_vals, want_idx = fused_score_topk(proj, panel, bits, TOPK,
                                           n_valid_cols=n_valid,
                                           return_values=True)
    for name in EXACT_VARIANTS:
        call(libs[name])
        torch.cuda.synchronize()
        check(torch.equal(idx, want_idx) and torch.equal(vals, want_vals),
              f"variant {name} returns the kernel's ids and values at "
              f"rank {rank}")
    times = dict.fromkeys(libs, 0.0)
    variants = list(variants)
    for name in ["full", *variants, *variants[::-1], "full"]:
        times[name] += time_ms(lambda: call(libs[name]), reps) / 2
    log("  sliced variants (ms): " + ", ".join(f"{k} {t:.3f}"
                                               for k, t in times.items()))
    return times


def rank300_part(geometry, device, out):
    """(a) PureSVD at rank 300 through ``evaluate()`` under the default
    route, on phase 3's data and split, against exact f64 factors."""
    import torch
    from polara_tpu_torch.models import PopularityModel, SVDModel
    from polara_tpu_torch.ops.fused_topk import fused_score_topk

    t0 = wall()
    data = phase3_data_model(geometry, device)
    out["data_s"] = wall() - t0
    model = SVDModel(data, device=device)
    model.verbose = False
    model.rank = C5_RANK
    fused_score_topk.launches = 0
    t0 = wall()
    hr = float(model.evaluate("relevance", simple_rates=True).hr)
    out["evaluate_s"] = wall() - t0
    ndcg = float(model.evaluate("ranking").ndcg)
    out["build_s"] = model.training_time[-1]
    out["launches"]["rank_300"] = fused_score_topk.launches
    out["svd_info"] = model.svd_info
    itemid = data.fields.itemid
    v300 = model.factors[itemid].contiguous()
    recs = model._device_recommendations()
    n_items = v300.shape[0]
    out["metrics"]["rank_300"] = {"hr": hr, "ndcg": ndcg}
    log(f"  PureSVD-{C5_RANK}: HR@{TOPK} {hr:.5f} NDCG@{TOPK} "
        f"{ndcg:.5f}; build {out['build_s']:.2f} s, evaluate "
        f"{out['evaluate_s']:.2f} s; {out['launches']['rank_300']} "
        f"launch(es)")
    check(out["launches"]["rank_300"] > 0,
          f"PureSVD-{C5_RANK} evaluate() launched the kernel")
    check(bool(((recs >= 0) & (recs < n_items)).all()),
          f"every id in [0, {n_items})")
    fused_ok_exact(model, "rank_300", out)

    # exact f64 factors from the Gram's eigendecomposition
    t0 = wall()
    d64 = model.get_training_matrix(dense=True).double()
    evals, evecs = torch.linalg.eigh(d64.T @ d64)
    del d64
    v_exact = evecs[:, -C5_RANK:].flip(1).float().contiguous()
    s_exact = evals[-C5_RANK:].flip(0).clamp(min=0).sqrt().float()
    del evals, evecs
    out["exact_factor_s"] = wall() - t0
    exact = SVDModel(data, device=device)
    exact.verbose = False
    exact.rank = C5_RANK
    exact.set_factors({data.fields.userid: None, itemid: v_exact,
                       "singular_values": s_exact})
    hr_ex = float(exact.evaluate("relevance", simple_rates=True).hr)
    ndcg_ex = float(exact.evaluate("ranking").ndcg)
    delta = max(abs(hr - hr_ex), abs(ndcg - ndcg_ex))
    overlap = _overlap(recs, exact._device_recommendations())
    out["metric_delta_vs_exact"], out["top10_overlap"] = delta, overlap
    out["metrics"]["rank_300_exact"] = {"hr": hr_ex, "ndcg": ndcg_ex}
    log(f"  exact f64 factors: HR@{TOPK} {hr_ex:.5f} NDCG@{TOPK} "
        f"{ndcg_ex:.5f} ({out['exact_factor_s']:.2f} s)")
    check(delta < 1e-3, f"metric_delta_vs_exact {delta:.2e} < 1e-3")
    check(overlap >= 0.99, f"top-{TOPK} overlap {overlap:.5f} >= 0.99")
    del exact

    popularity = PopularityModel(data, device=device)
    popularity.verbose = False
    out["metrics"]["popularity"] = {
        "hr": float(popularity.evaluate("relevance", simple_rates=True).hr)}

    # the kernel at the main path's shape and rank 300
    plan = model._test_plan
    check(len(plan.chunks) == 1, "one chunk holds every test user")
    proj = SVDModel.proj_chunk(model.score_params(), plan.chunks[0])
    proj = proj.contiguous()
    bits = plan.seen_bits(0, n_items)
    out["kernel"] = sweep_kernel_fields(proj, v300, bits, n_items)
    agree, out["kernel"]["max_abs_err"] = _compare(proj, v300, bits, TOPK)
    out["kernel"]["exact_agreement"] = agree
    if proj.is_cuda:
        out["kernel"]["variant_ms"] = sliced_variant_ms(proj, v300, bits,
                                                        n_items)
    log(f"  kernel at {proj.shape[0]} x {n_items} x {C5_RANK}: "
        + json.dumps(out["kernel"]))
    out["kernel_k100"] = k_fields(proj, v300, bits, n_items, 100)
    log(f"  kernel at k=100: {json.dumps(out['kernel_k100'])}")
    return data, model


def rank300_sweep_part(geometry, device, out):
    """(a') ``find_optimal_svd_rank`` over ranks 250 and 300 on phase 5's
    data: both ranks launch the kernel, and rank 250's picks from the
    zero-padded factors (the sliced kernel) equal the truncated factors'
    (the whole-rank kernel) bit for bit."""
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import make_realistic_coo_device
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.evaluation.pipelines import (evaluate_models,
                                                       find_optimal_svd_rank)
    from polara_tpu_torch.models import SVDModel
    from polara_tpu_torch.ops.fused_topk import fused_score_topk

    frame = events_frame(*make_realistic_coo_device(**geometry, seed=0,
                                                    device=device))
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    data.warm_start = False
    data.test_ratio = 0.05
    data.holdout_size = 1
    data.prepare()
    launches = {}

    def counted(model, target, **kwargs):
        fused_score_topk.launches = 0
        result = evaluate_models(model, target, **kwargs)
        launches[model.rank] = fused_score_topk.launches
        return result

    model = SVDModel(data, device=device)
    model.verbose = False
    # a fixed-count build (svd_iters passes): (a) times the default
    # tolerance build at rank 300; this part gates the sweep's scoring
    model.svd_tol = None
    t0 = wall()
    _, scores = find_optimal_svd_rank(model, list(C5_SWEEP_RANKS), "arhr",
                                         return_scores=True,
                                         evaluator=counted)
    out["sweep_s"] = wall() - t0
    out["sweep_build_s"] = model.training_time[-1]
    out["sweep_arhr"] = {int(r): float(v) for r, v in scores.items()}
    out["launches"]["rank_300_sweep"] = sum(launches.values())
    log(f"  sweep {C5_SWEEP_RANKS}: {out['sweep_s']:.2f} s, ARHR "
        f"{json.dumps(out['sweep_arhr'])}, launches per rank "
        f"{json.dumps(launches)}")
    for rank in C5_SWEEP_RANKS:
        check(launches.get(rank, 0) > 0,
              f"the sweep's rank {rank} launched the kernel")
    padded_rank_gates(model._test_plan,
                      model.factors[data.fields.itemid].contiguous(),
                      (min(C5_SWEEP_RANKS),))


def mml_part(data, svd50, v300, device, out):
    """(b) ``MyMediaLiteWrapper`` through the stand-in at ML-10M geometry:
    WRMF at rank 50 carrying phase 3's PureSVD-50 factors, BPRMF at rank
    256 carrying (a)'s factors with the item log-popularity as the bias
    (257 columns after the QR: the sliced kernel)."""
    import tempfile
    from pathlib import Path

    import torch
    from polara_tpu_torch.models import SVDModel
    from polara_tpu_torch.models.external import MyMediaLiteWrapper
    from polara_tpu_torch.ops.fused_topk import fused_score_topk

    userid, itemid = data.fields.userid, data.fields.itemid
    old_by_new = data.index.itemid.sort_values("new")["old"].to_numpy()
    v50 = svd50[torch.from_numpy(old_by_new.copy()).to(svd50.device)]
    dense = SVDModel(data, device=device).get_training_matrix(dense=True)
    counts = (dense != 0).sum(0).double()
    build_dir = Path(__file__).resolve().parent / "polara_tpu_torch" / "_build"
    build_dir.mkdir(parents=True, exist_ok=True)

    def step_timer(model, times):
        for name in ("_save_to_disk", "_run_external", "_parse_factors",
                     "_make_factors_orthogonal"):
            def timed(*args, _fn=getattr(model, name), _name=name, **kw):
                t = wall()
                result = _fn(*args, **kw)
                times[_name] = wall() - t
                return result
            setattr(model, name, timed)

    def wrapper(method, rank, item, bias, tmp, **attrs):
        user = (dense @ item).cpu().numpy()
        library = Path(tmp) / method
        library.mkdir()
        write_mml_stand_in(library, user, item.cpu().numpy(), bias)
        model = MyMediaLiteWrapper(str(library), tmp, method, data,
                                   device=device)
        model.verbose = False
        model.rank = rank
        for key, value in attrs.items():
            setattr(model, key, value)
        times = out["mml_s"].setdefault(method, {})
        step_timer(model, times)
        return model, user, times

    reference = SVDModel(data, device=device)
    reference.verbose = False
    reference.rank = MML_WRMF_RANK
    reference.set_factors({userid: None, itemid: v50.contiguous()})
    ref_hr = float(reference.evaluate("relevance", simple_rates=True).hr)
    ref_recs = reference._device_recommendations()

    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        # WRMF: raw placement, then the default QR fold-in
        model, user, times = wrapper("WRMF", MML_WRMF_RANK, v50, None, tmp,
                                     orthogonal_factors=False)
        t0 = wall()
        model.build()
        times["build"] = wall() - t0
        check(torch.equal(model.factors[userid].cpu(),
                          torch.as_tensor(user, dtype=torch.float32))
              and torch.equal(model.factors[itemid], v50),
              "WRMF without the QR: every factor row lands on its "
              "framework id exactly")
        model.orthogonal_factors = True
        t0 = wall()
        model.build()
        times["build"] = wall() - t0
        fused_score_topk.launches = 0
        t0 = wall()
        hr = float(model.evaluate("relevance", simple_rates=True).hr)
        times["evaluate"] = wall() - t0
        out["launches"]["mml_wrmf"] = fused_score_topk.launches
        overlap = _overlap(model._device_recommendations(), ref_recs)
        out["metrics"]["mml_wrmf"] = {"hr": hr, "hr_puresvd50": ref_hr,
                                      "overlap_puresvd50": overlap}
        log(f"  MML WRMF-{MML_WRMF_RANK}: HR@{TOPK} {hr:.5f} (PureSVD-50 "
            f"{ref_hr:.5f}), top-{TOPK} overlap {overlap:.5f}; steps (s) "
            + json.dumps(times))
        check(out["launches"]["mml_wrmf"] > 0, "WRMF launched the kernel")
        check(overlap >= 0.999, f"WRMF top-{TOPK} overlap with PureSVD-50 "
              f"{overlap:.5f} >= 0.999")
        check(abs(hr - ref_hr) <= 1e-4, f"WRMF HR@{TOPK} {hr:.5f} within "
              f"1e-4 of PureSVD-50's {ref_hr:.5f}")
        del model

        # BPRMF: (a)'s factors at 256 + the log-popularity bias
        bias = torch.log1p(counts).cpu().numpy()
        model, _, times = wrapper("BPRMF", MML_BPR_RANK,
                                  v300[:, :MML_BPR_RANK].contiguous(), bias,
                                  tmp)
        t0 = wall()
        model.build()
        times["build"] = wall() - t0
        fused_score_topk.launches = 0
        t0 = wall()
        hr = float(model.evaluate("relevance", simple_rates=True).hr)
        times["evaluate"] = wall() - t0
        out["launches"]["mml_bprmf"] = fused_score_topk.launches
        width = model.factors[itemid].shape[1]
        pop_hr = out["metrics"]["popularity"]["hr"]
        out["metrics"]["mml_bprmf"] = {"hr": hr, "columns": width}
        log(f"  MML BPRMF-{MML_BPR_RANK}: {width} columns, HR@{TOPK} "
            f"{hr:.5f} (popularity {pop_hr:.5f}); steps (s) "
            + json.dumps(times))
        check(width == MML_BPR_RANK + 1,
              f"BPRMF scores {width} columns (rank + bias)")
        check(out["launches"]["mml_bprmf"] > 0, "BPRMF launched the kernel")
        fused_ok_exact(model, "mml_bprmf", out)
        check(hr > pop_hr, f"BPRMF HR@{TOPK} {hr:.5f} > popularity's "
              f"{pop_hr:.5f}")


def external_phase(geometry, svd50, device="cuda"):
    """Phase 13.  ``svd50``: phase 3's PureSVD-50 item factors (rows by
    phase 3's item ids).  Raises on a failed gate; the caller checks the
    launch counts again."""
    import torch
    t_phase = wall()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    out = {"launches": {}, "metrics": {}, "fused_exact_agreement": {},
           "mml_s": {}}
    data, model = rank300_part(geometry, device, out)
    v300 = model.factors[data.fields.itemid].contiguous()
    del model
    rank300_sweep_part(geometry, device, out)
    mml_part(data, svd50, v300, device, out)
    out["peak_mem_gib"] = (torch.cuda.max_memory_allocated() / 2 ** 30
                           if on_card else None)
    out["phase_s"] = wall() - t_phase
    return out


def nvidia_smi(query: str, fmt: str = "csv,noheader") -> str:
    """Card 0's line of ``nvidia-smi --query-gpu=<query>``."""
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0].strip()


def bound_ms(flop: float, nbytes: float):
    """(least ms, "operations" or "bytes"): the f32 FMA peak of card 0 (SMs
    x 128 lanes x 2 FLOP x its max SM clock) against the HBM rate."""
    import torch
    mhz = float(nvidia_smi("clocks.max.sm", "csv,noheader,nounits"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    t_ops = flop / (sms * F32_LANES_PER_SM * 2 * mhz * 1e6) * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def build_phase():
    """Phase 1: build the kernels and their measurement variants, one nvcc
    each, all at once; print ptxas's registers and spills and require none
    in the k <= 32 instantiations of both score kernels (the main path's
    and the sliced ring's)."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from polara_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    variants = [*PHASE_VARIANTS.values(), *SLICED_VARIANTS.values()]
    with ThreadPoolExecutor(1 + len(variants)) as pool:
        for built in [pool.submit(_cuda_build.build, defines) for defines
                      in [(), *variants]]:
            built.result()
    _cuda_build.load_library()
    build_s = time.perf_counter() - t0
    report = {}
    for name, r in _cuda_build.ptxas_report(_cuda_build.build_log).items():
        found = re.search(r"([a-z_]+_kernel)(?:ILi(\d+)E)?", name)
        short = name if not found else found.group(1) + (
            f"<{found.group(2)}>" if found.group(2) else "")
        report[short] = r
        log(f"  ptxas {short}: {r}")
    for kernel in ("score_topk_kernel<1>", "score_topk_sliced_kernel<1>"):
        r = report.get(kernel, {})
        check(r.get("spill_stores") == 0 and r.get("spill_loads") == 0,
              f"ptxas: no spills in {kernel}")
    log(f"  kernel build {build_s:.2f} s")
    return build_s, report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if importlib.util.find_spec("pandas") is None:
        print("chip_smoke: pandas is missing; the data-model phases (4-13) "
              "need it", file=sys.stderr)
        return 1
    from polara_tpu_torch.datasets import (ML1M_GEOMETRY, ML10M_GEOMETRY,
                                           NETFLIX_GEOMETRY)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = nvidia_smi("name,power.limit")
    log(f"gpu: {card}")

    log("phase 1: build the kernels")
    t0 = time.perf_counter()
    build_s, ptxas = build_phase()
    log(f"  phase 1: {time.perf_counter() - t0:.2f} s")

    log("phase 2: kernel vs plain version")
    t0 = time.perf_counter()
    kernel_phase()
    log(f"  phase 2: {time.perf_counter() - t0:.2f} s")

    # item factors of phases 3, 7 and 8, served in phase 9
    trained = {}
    log("phase 3: PureSVD rank 50 at ML-10M geometry")
    t0 = time.perf_counter()
    main = main_path(ML10M_GEOMETRY, trained=trained)
    check(main["launches"] > 0,
          f"the main path launched the kernel ({main['launches']}x)")
    log(f"  phase 3: {time.perf_counter() - t0:.2f} s")
    log("  " + json.dumps({"main_path": main}))

    log("phase 4: cross-validation at ML-1M geometry through the data "
        "model")
    t0 = time.perf_counter()
    cv = cv_phase(ML1M_GEOMETRY)
    for fold, record in cv["folds"].items():
        for method in ("PureSVD", "PureSVD-s"):
            check(record["launches"][method] > 0,
                  f"fold {fold}: {method} launched the kernel "
                  f"({record['launches'][method]}x)")
    log(f"  phase 4: {time.perf_counter() - t0:.2f} s")
    log("  " + json.dumps({"cv": cv}))

    log("phase 5: rank sweep 10..150 at ML-10M geometry")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    sweep = sweep_phase(ML10M_GEOMETRY)
    check(sweep["launches"] >= 15,
          f"the cold sweep launched the kernel {sweep['launches']}x (>= 15)")
    log(f"  phase 5: {time.perf_counter() - t0:.2f} s")
    log("  " + json.dumps({"sweep": sweep}))

    log("phase 6: PureSVD rank 50 at ML-10M geometry over (4, 1) and "
        "(2, 2) meshes")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mesh = mesh_phase(ML10M_GEOMETRY)
    for name, launched in mesh["launches"].items():
        check(launched == mesh["expected_launches"][name],
              f"{name}: the counted drive launched the kernel {launched}x "
              f"== user shards x item shards x chunks")
    log(f"  phase 6: {time.perf_counter() - t0:.2f} s")
    log("  " + json.dumps({"mesh": mesh}))

    log("phase 7: iALS, BPR and PMF at ML-10M geometry, their mesh "
        "trainers, iALS warm start at ML-1M geometry")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    factor = factor_phase(ML10M_GEOMETRY, ML1M_GEOMETRY, trained=trained)
    for name in ("ials_dense", "ials_events", "bpr", "pmf"):
        check(factor["launches"][name] > 0,
              f"{name} launched the kernel ({factor['launches'][name]}x)")
    for name in ("mesh_1d", "mesh_2d"):
        check(factor["launches"][name]
              == 4 * factor["launches"]["single_fixed"],
              f"iALS on {name}: {factor['launches'][name]} launches == 4 "
              f"shards x chunks")
    log(f"  phase 7: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{factor['peak_mem_gib']:.2f} GiB")
    log("  " + json.dumps({"factor": factor}))

    log("phase 8: CoFFee (HOOI) mlrank (13, 10, 2) at ML-10M geometry, its "
        "rank search, mesh trainer and mesh scorings; the dense tier at "
        "ML-1M geometry")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tensor = tensor_phase(ML10M_GEOMETRY, ML1M_GEOMETRY, trained=trained)
    check(tensor["launches"]["tensor"] > 0,
          f"the tensor path launched the kernel "
          f"({tensor['launches']['tensor']}x)")
    check(tensor["launches"]["tuning"] >= tensor["tuning_cells"],
          f"the rank search launched the kernel "
          f"{tensor['launches']['tuning']}x (>= its "
          f"{tensor['tuning_cells']} cells)")
    for name in ("tensor_mesh_1d", "tensor_mesh_2d"):
        check(tensor["launches"][name] == tensor["mesh_expected"][name],
              f"CoFFee on {name}: {tensor['launches'][name]} launches == "
              f"user shards x item shards x chunks")
    log(f"  phase 8: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{tensor['peak_mem_gib']:.2f} GiB")
    log("  " + json.dumps({"tensor": tensor}))

    log("phase 9: ServingBundle at the ML-10M catalog (PureSVD, iALS, BPR, "
        "CoFFee), batch 1,024, top-10")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    serving = serving_phase(trained)
    svd50 = trained["svd"]      # phase 13's WRMF carries these factors
    del trained
    for name in ("svd", "ials", "bpr", "coffee"):
        check(serving["launches"][name] > 0,
              f"the {name} bundle launched the kernel "
              f"({serving['launches'][name]}x)")
    log(f"  phase 9: {time.perf_counter() - t0:.2f} s")
    log("  " + json.dumps({"serving": serving}))

    log("phase 10: HybridSVD rank 30 at ML-10M geometry through "
        "SimilarityDataModel, ScaledHybridSVD, SIM; KPMF and LCE at ML-1M "
        "geometry; item cold start at ML-10M geometry; HybridSVD serving")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    side = side_phase(ML10M_GEOMETRY, ML1M_GEOMETRY)
    for name in ("hybrid", "scaled_hybrid", "hybrid_identity", "kpmf", "lce",
                 "hybrid_serving"):
        check(side["launches"][name] > 0,
              f"{name} launched the kernel ({side['launches'][name]}x)")
    log(f"  phase 10: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{side['peak_mem_gib']:.2f} GiB")
    log("  " + json.dumps({"side": side}))

    log("phase 11: PureSVD rank 50 at Netflix geometry through the split "
        "(two budgets) and tiled streaming operators, every user scored; "
        "distributed_chunked_rsvd and ImplicitALS past the budget on (4, 1) "
        "meshes; the exact f64 reference; the dense route's build")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    stream = streaming_phase(NETFLIX_GEOMETRY, ML10M_GEOMETRY)
    for name in ("split_jax", "split_port", "tiled", "exact", "popularity"):
        check(stream["launches"][name] == 1,
              f"{name} launched the kernel once over all "
              f"{NETFLIX_GEOMETRY['n_users']} users "
              f"({stream['launches'][name]}x)")
    check(stream["launches"]["mesh"] == 2,
          f"the mesh build and its single-device twin launched the kernel "
          f"({stream['launches']['mesh']}x == 2)")
    for name in ("ials_mesh", "ials_single"):
        check(stream["launches"][name] > 0,
              f"{name} launched the kernel ({stream['launches'][name]}x)")
    log(f"  phase 11: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{stream['peak_mem_gib']:.2f} GiB")
    log("  " + json.dumps({"stream": stream}))

    log("phase 12: the evaluation protocols: long-tail PureSVD at ML-10M "
        "geometry through the kernel, sampled-candidate evaluation on its "
        "split (registered and on the fly); ML-1M geometry through the "
        "MovieLens loader: EigenRec and contextual post-filtering")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    protocols = protocols_phase(ML10M_GEOMETRY, ML1M_GEOMETRY)
    for name in ("long_tail", "contextual_plain"):
        check(protocols["launches"][name] > 0,
              f"{name} launched the kernel "
              f"({protocols['launches'][name]}x)")
    for name in ("sampled", "contextual"):
        check(protocols["launches"][name] == 0,
              f"{name} launched no kernel "
              f"({protocols['launches'][name]}x)")
    log(f"  phase 12: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{protocols['peak_mem_gib']:.2f} GiB; times on {card}")
    log("  " + json.dumps({"protocols": protocols}))

    log("phase 13: PureSVD rank 300 at ML-10M geometry through evaluate() "
        "(the kernel walks the rank in slices), the rank sweep (250, 300); "
        "MyMediaLiteWrapper WRMF-50 and BPRMF-256 through a stand-in CLI")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    external = external_phase(ML10M_GEOMETRY, svd50)
    del svd50
    for name in ("rank_300", "rank_300_sweep", "mml_wrmf", "mml_bprmf"):
        check(external["launches"][name] > 0,
              f"{name} launched the kernel ({external['launches'][name]}x)")
    log(f"  phase 13: {time.perf_counter() - t0:.2f} s; peak memory "
        f"{external['peak_mem_gib']:.2f} GiB; times on {card}")
    log("  " + json.dumps({"external": external}))

    least_ms, bound_by = bound_ms(main["kernel_flop"], main["kernel_bytes"])
    top = dict(sweep["kernel"])
    top["bound_ms"], top["bound_by"] = bound_ms(top.pop("flop"),
                                                top.pop("bytes"))
    top["max_abs_err"] = sweep["max_abs_err"]
    shards = {}
    for name, fields in mesh["shards"].items():
        fields = dict(fields)
        fields["bound_ms"], fields["bound_by"] = bound_ms(
            fields.pop("flop"), fields.pop("bytes"))
        shards[name] = fields
    shapes = {}
    for name, fields in (("rank_300", external["kernel"]),
                         ("rank_300_k100", external["kernel_k100"]),
                         ("main_k100", main["k100"]),
                         ("tensor_scoring", tensor["kernel"]),
                         ("serving_batch", serving["kernel"]),
                         ("hybrid_scoring", side["kernel"]),
                         ("netflix_scoring", stream["kernel"])):
        fields = dict(fields)
        fields["bound_ms"], fields["bound_by"] = bound_ms(
            fields.pop("flop"), fields.pop("bytes"))
        shapes[name] = fields
    log(json.dumps({"kernels": [{
        "name": "fused_score_topk", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": main["launches"],
        "launches_by_path": {"main": main["launches"], "cv": cv["launches"],
                             "sweep": sweep["launches"],
                             **mesh["launches"],
                             "factor": sum(factor["launches"][name] for name
                                           in ("popularity", "ials_dense",
                                               "ials_events", "bpr", "pmf")),
                             "factor_mesh": factor["mesh_launches"],
                             "tensor": tensor["launches"]["tensor"],
                             "tensor_tuning": tensor["launches"]["tuning"],
                             "tensor_mesh": tensor["launches"]["tensor_mesh"],
                             "serving": serving["launches"]["serving"],
                             "hybrid": sum(side["launches"][name] for name
                                           in ("hybrid", "scaled_hybrid",
                                               "hybrid_identity")),
                             "hybrid_lce": (side["launches"]["lce"]
                                            + side["launches"]["kpmf"]),
                             "hybrid_serving":
                                 side["launches"]["hybrid_serving"],
                             "stream": stream["launches"]["main"],
                             "stream_exact_popularity": (
                                 stream["launches"]["exact"]
                                 + stream["launches"]["popularity"]),
                             "stream_mesh": stream["launches"]["mesh"],
                             "stream_ials": (
                                 stream["launches"]["ials_mesh"]
                                 + stream["launches"]["ials_single"]),
                             "protocols": sum(
                                 protocols["launches"].values()),
                             "rank_300": (
                                 external["launches"]["rank_300"]
                                 + external["launches"]["rank_300_sweep"]),
                             "external": (
                                 external["launches"]["mml_wrmf"]
                                 + external["launches"]["mml_bprmf"])},
        "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": least_ms, "bound_by": bound_by,
        "library_ms": main["stage_ms"]["cublas_scores_only"],
        "topk_ms": main["stage_ms"]["topk_baseline"],
        "splits": main["splits"], "blocks_per_sm": main["blocks_per_sm"],
        "unsplit_ms": main["unsplit_ms"],
        "phase_ms": main["phase_ms"],
        "clocks_under_load": main["kernel_clocks"],
        "ptxas": ptxas, "sweep_top_rank": top, "mesh_shard": shards,
        "mesh_merge_ms": mesh.get("merge_ms"), **shapes}],
        "build_s": build_s}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
