"""Drive the PyTorch/CUDA port (``polara_tpu_torch``) once on one GPU.

    python3 chip_smoke.py

Phases, in order; any failed check raises and the script exits non-zero:

1. Build the CUDA kernels from ``polara_tpu_torch/csrc`` (nvcc, sm_90a),
   and beside them, in parallel, the kernel's measurement variants
   (``PHASE_VARIANTS``); print ptxas's registers and spills, and require
   no spills in the top-k kernel's k <= 32 instantiation.
2. Kernel vs plain version on the card: the JAX package's kernel test
   shapes, the tiling's edge cases (``EDGE_CASES``, integer factors
   bit-identical, Gaussian ones re-scored), an integer tie case, a PAD
   case, a ``filter_seen=False`` case and the main path's shape.
3. The main path at ML-10M geometry (69,878 users x 10,677 items, ~10M
   events): seeded data on the card, one held-out event per user, dense
   block + bf16 power operator, PureSVD rank 50 by randomized subspace
   iteration, ``run_scoring_fused`` (popularity item order) ->
   ``metrics_core``.  Gates: the kernel ran, ids in range, ``fused_ok``,
   triplet residual, metric delta and top-10 overlap against exact f64
   factors from the Gram's eigendecomposition.  At the main path's own
   inputs: the kernel against its plain version, its time, and the times
   of its measurement variants (``phase_ms``).
4. Where pandas is installed: ``RecommenderData`` -> ``prepare()`` ->
   ``SVDModel`` (rank 50) -> ``evaluate()`` at ML-1M geometry.

Prints the card's name and power limit, a JSON line describing each
kernel (its time at the main path's inputs beside the plain version's,
its bound: the f32 FMA work at the card's peak from its SM count and
max SM clock, or the bytes at the HBM rate, whichever is larger; the
cuBLAS scores-only product as ``library_ms`` and the ``torch.topk``
route as ``topk_ms``; the SM clock under load; ``launches`` counts calls
of the C entry point, each of which runs the panel transpose and then the
score kernel), and as the last line ``{"ok": true, "device": {...}}``.  Without
CUDA, or without the package beside it, it exits non-zero and prints no
result.
"""
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
]
# builds of fused_topk.cu that switch a part off (macros at its head),
# timed beside the kernel at the main path's inputs
PHASE_VARIANTS = {
    "sync_staging": ("POLARA_SYNC_STAGING",),
    "no_selection": ("POLARA_PHASE_NO_SELECTION",),
    "transpose_only": ("POLARA_PHASE_TRANSPOSE_ONLY",),
}
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


def main_path(geometry, device="cuda", verify_users=VERIFY_USERS):
    """Phase 3.  Returns the measured fields; raises on a failed gate
    (except the kernel launch count, which the caller checks)."""
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
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
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
    items_t = torch.empty((rank, panel_columns(n_valid)),
                          dtype=torch.float32, device=proj.device)
    stream = torch.cuda.current_stream().cuda_stream
    libs = {"full": load_library()}
    libs.update({name: load_library(defines)
                 for name, defines in PHASE_VARIANTS.items()})

    def call(lib):
        err = lib.polara_fused_score_topk(
            proj.data_ptr(), panel.data_ptr(), items_t.data_ptr(),
            bits.data_ptr(), vals.data_ptr(), idx.data_ptr(), n_users,
            panel.shape[0], rank, bits.shape[1], n_valid, TOPK, 1, stream)
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
# phase 4: the data model at ML-1M geometry
# --------------------------------------------------------------------------

def data_model_phase(device="cuda"):
    from polara_tpu_torch.data import RecommenderData
    from polara_tpu_torch.datasets import (ML1M_GEOMETRY,
                                           make_realistic_coo_device)
    from polara_tpu_torch.datasets.synthetic import events_frame
    from polara_tpu_torch.models import SVDModel
    from polara_tpu_torch.ops.fused_topk import fused_score_topk

    frame = events_frame(*make_realistic_coo_device(**ML1M_GEOMETRY, seed=0,
                                                    device=device))
    data = RecommenderData(frame, "userid", "movieid", "rating", seed=0,
                           verbose=False)
    t0 = time.perf_counter()
    data.prepare()
    prepare_s = time.perf_counter() - t0
    model = SVDModel(data, device=device)
    model.verbose = False
    model.rank = RANK
    before = fused_score_topk.launches
    t0 = time.perf_counter()
    scores = model.evaluate()
    evaluate_s = time.perf_counter() - t0
    launched = fused_score_topk.launches - before
    check(launched > 0, f"evaluate() launched the kernel ({launched}x)")
    out = {"prepare_s": prepare_s, "evaluate_s": evaluate_s,
           "build_s": model.training_time[-1], "launches": launched}
    for tup in scores:
        out.update({k: v for k, v in tup._asdict().items() if v is not None})
    check(all(np.isfinite(x) for x in out.values()), "finite metrics")
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
    in the top-k kernel's k <= 32 instantiation (the main path's)."""
    import re
    from concurrent.futures import ThreadPoolExecutor
    from polara_tpu_torch.ops import _cuda_build
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1 + len(PHASE_VARIANTS)) as pool:
        for built in [pool.submit(_cuda_build.build, defines) for defines
                      in [(), *PHASE_VARIANTS.values()]]:
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
    main = report.get("score_topk_kernel<1>", {})
    check(main.get("spill_stores") == 0 and main.get("spill_loads") == 0,
          "ptxas: no spills in score_topk_kernel<1>")
    log(f"  kernel build {build_s:.2f} s")
    return build_s, report


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from polara_tpu_torch.datasets import ML10M_GEOMETRY

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")
    card = nvidia_smi("name,power.limit")
    log(f"gpu: {card}")

    log("phase 1: build the kernels")
    build_s, ptxas = build_phase()

    log("phase 2: kernel vs plain version")
    kernel_phase()

    log("phase 3: PureSVD rank 50 at ML-10M geometry")
    main = main_path(ML10M_GEOMETRY)
    check(main["launches"] > 0,
          f"the main path launched the kernel ({main['launches']}x)")
    log("  " + json.dumps({"main_path": main}))

    has_pandas = importlib.util.find_spec("pandas") is not None
    log(f"phase 4: data model at ML-1M geometry (pandas "
        f"{'present' if has_pandas else 'missing: phase skipped'})")
    if has_pandas:
        log("  " + json.dumps({"data_model": data_model_phase()}))

    least_ms, bound_by = bound_ms(main["kernel_flop"], main["kernel_bytes"])
    log(json.dumps({"kernels": [{
        "name": "fused_score_topk", "route": "cuda",
        "source": KERNEL_SOURCE, "replaces": KERNEL_REPLACES,
        "launches": main["launches"], "max_abs_err": main["max_abs_err"],
        "ms": main["kernel_ms"], "plain_ms": main["plain_ms"],
        "bound_ms": least_ms, "bound_by": bound_by,
        "library_ms": main["stage_ms"]["cublas_scores_only"],
        "topk_ms": main["stage_ms"]["topk_baseline"],
        "phase_ms": main["phase_ms"],
        "clocks_under_load": main["kernel_clocks"],
        "ptxas": ptxas}], "build_s": build_s}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
