"""Plain reference of PureSVD (Cremonesi et al., RecSys 2010).

The exact rank-k right singular subspace of the training matrix ``A``:
the top eigenpairs of the Gram ``AᵀA``, formed in f64 from the
benchmark's own events in blocks of users and solved by a dense symmetric
eigensolver.  PureSVD scores a known user's items as ``r_u V Vᵀ``.

It judges the program's build by the item factors ``V`` that the build
returned, which are all that PureSVD's scores use:

* ``svd_vec_resid``: the widest eigen-residual ``‖AᵀA v_i - ρ_i v_i‖ /
  (‖v_i‖ σ_1²)`` over the k columns, with ``ρ_i`` the Rayleigh quotient
  of ``v_i``.  A column that mixes singular directions of nearly equal value
  reads small, as it should: PureSVD's scores do not tell them apart.
* ``svd_energy_gap``: ``1 - trace(QᵀAᵀAQ) / Σ σ_i²`` over ``Q``, an
  orthonormal basis of ``V``'s span (f64): the share of the best rank-k
  energy that the program's subspace misses.  It reads about 1 for a
  subspace that is not the top one, which a residual alone would pass.

The singular values ``s`` are not compared: the scores do not use them,
and their f32 error has a long tail from seed to seed that a TF32 build
does not clear (PERF.md, section 6).
"""
from __future__ import annotations

import numpy as np
import torch

from portbench import plain, work

F64 = torch.float64


def prepare(problem: plain.Problem, cfg: dict, seed: int, device) -> dict:
    k = cfg["model"]["attributes"]["rank"]
    gram = torch.zeros((problem.n_items, problem.n_items), dtype=F64,
                       device=device)
    for lo, hi in plain.user_blocks(problem.n_users):
        block = plain.dense_rows(problem, np.arange(lo, hi), device)
        gram += block.T @ block
        del block
    evals = torch.linalg.eigvalsh(gram)
    lam = evals.flip(0)[:k]
    return {"gram": gram, "lam1": float(lam[0]), "energy": float(lam.sum()),
            "k": k}


def factor_checks(state: dict, factors: dict) -> dict:
    v = factors["movieid"].to(state["gram"].device, F64)
    if v.shape[1] != state["k"]:
        return {"svd_vec_resid": float("inf"),
                "svd_energy_gap": float("inf")}
    gv = state["gram"] @ v
    rho = (v * gv).sum(0) / (v * v).sum(0)
    resid = (torch.linalg.norm(gv - v * rho[None, :], dim=0)
             / torch.linalg.norm(v, dim=0)).max()
    q, _ = torch.linalg.qr(v)
    captured = torch.trace(q.T @ state["gram"] @ q)
    return {"svd_vec_resid": float(resid) / state["lam1"],
            "svd_energy_gap": abs(1.0 - float(captured) / state["energy"])}


def user_panel(factors: dict, problem: plain.Problem, rows: np.ndarray,
               device, dtype=F64) -> torch.Tensor:
    """``r_u V`` of the tested users ``rows``."""
    users = problem.test_users[rows]
    v = factors["movieid"].to(device, dtype)
    return plain.dense_rows(problem, users, device, dtype) @ v


def item_panel(factors: dict, device, dtype=F64) -> torch.Tensor:
    return factors["movieid"].to(device, dtype)


def model_flops(cfg: dict, problem: plain.Problem) -> float:
    """The configuration's fixed work per step: a fixed-count randomized
    subspace build at the port's default iteration count and block, then
    scoring every tested user."""
    attrs = cfg["model"]["attributes"]
    k = attrs["rank"]
    iters = cfg["model"]["fixed_iterations"]
    build = work.rsvd_fixed_flops(problem.n_users, problem.n_items, k, iters)
    n_test = len(problem.test_users)
    test_nnz = int((problem.user_start[problem.test_users + 1]
                    - problem.user_start[problem.test_users]).sum())
    return build + work.projection_flops(test_nnz, k) + \
        work.topk_flops(n_test, problem.n_items, k)
