"""Plain reference of implicit ALS (Hu, Koren, Volinsky, ICDM 2008).

Confidence ``c = 1 + α·log2(1 + r/ε)`` on observed ratings and 1
elsewhere, preference 1 on observed items; each half-sweep solves, for
every user (then item), ``(YᵀY + Yᵀ(C_u - I)Y + λI) x_u = Yᵀ C_u p_u``
by Cholesky, in f64.  The weighted Grams of a block of users come from
one product of the block's ``C - I`` with the rows of ``y_i ⊗ y_i``.

The start is the port's documented one, worked out again from the seed:
item factors ``N(0, 1/rank)`` drawn in f32 by a ``torch.Generator`` on the
device seeded with the model's ``seed``, user factors solved first.

``als_gap`` judges the build: the wider of ``‖X - X_ref‖ / ‖X_ref‖`` and
``‖Y - Y_ref‖ / ‖Y_ref‖`` after the configured epochs.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from portbench import plain, synthetic, work

F64 = torch.float64


def _settings(cfg: dict) -> dict:
    attrs = cfg["model"]["attributes"]
    fixed = cfg["model"]["defaults"]
    return {**fixed, **attrs}


def _confidence_margin(problem: plain.Problem, opts: dict, device):
    """Dense ``C - I`` (zero where unobserved), f64."""
    margin = torch.zeros((problem.n_users, problem.n_items), dtype=F64,
                         device=device)
    vals = torch.as_tensor(problem.vals, dtype=F64, device=device)
    margin[torch.as_tensor(problem.rows, device=device),
           torch.as_tensor(problem.cols, device=device)] = \
        opts["alpha"] * torch.log2(vals / opts["epsilon"] + 1.0)
    return margin


def _half_sweep(margin_rows, n_rows: int, fixed: torch.Tensor, reg: float,
                block: int) -> torch.Tensor:
    k = fixed.shape[1]
    gram = fixed.T @ fixed + reg * torch.eye(k, dtype=F64,
                                             device=fixed.device)
    outer = (fixed[:, :, None] * fixed[:, None, :]).reshape(-1, k * k)
    out = torch.empty((n_rows, k), dtype=F64, device=fixed.device)
    for lo in range(0, n_rows, block):
        hi = min(lo + block, n_rows)
        c = margin_rows(lo, hi)
        a = gram[None] + (c @ outer).reshape(hi - lo, k, k)
        rhs = torch.where(c > 0, c + 1.0, 0.0) @ fixed
        out[lo:hi] = torch.linalg.solve(a, rhs)
        del c, a, rhs
    return out


def initial_items(n_items: int, rank: int, seed: int, device):
    gen = torch.Generator(device=device)
    gen.manual_seed(synthetic.torch_seed(seed))
    return torch.randn((n_items, rank), generator=gen, dtype=torch.float32,
                       device=device) * (1.0 / math.sqrt(rank))


def prepare(problem: plain.Problem, cfg: dict, seed: int, device) -> dict:
    opts = _settings(cfg)
    k = opts["rank"]
    margin = _confidence_margin(problem, opts, device)
    items = initial_items(problem.n_items, k, seed, device).to(F64)
    users = None
    for _ in range(opts["num_epochs"]):
        users = _half_sweep(lambda lo, hi: margin[lo:hi], problem.n_users,
                            items, opts["regularization"], 8192)
        items = _half_sweep(lambda lo, hi: margin[:, lo:hi].T,
                            problem.n_items, users,
                            opts["regularization"], 2048)
    del margin
    return {"users": users, "items": items}


def _relative_gap(got: torch.Tensor, ref: torch.Tensor) -> float:
    if got is None or tuple(got.shape) != tuple(ref.shape):
        return float("inf")
    got = got.to(ref.device, F64)
    return float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref))


def factor_checks(state: dict, factors: dict) -> dict:
    return {"als_gap": max(
        _relative_gap(factors.get("userid"), state["users"]),
        _relative_gap(factors.get("movieid"), state["items"]))}


def user_panel(factors: dict, problem: plain.Problem, rows: np.ndarray,
               device, dtype=F64) -> torch.Tensor:
    """The tested users' own factor rows."""
    users = torch.as_tensor(problem.test_users[rows], device=device)
    return factors["userid"].to(device, dtype)[users]


def item_panel(factors: dict, device, dtype=F64) -> torch.Tensor:
    return factors["movieid"].to(device, dtype)


def model_flops(cfg: dict, problem: plain.Problem) -> float:
    """Hu et al.'s direct solve for the configured epochs, then scoring
    every tested user."""
    opts = _settings(cfg)
    build = work.ials_direct_flops(problem.n_users, problem.n_items,
                                   len(problem.rows), opts["rank"],
                                   opts["num_epochs"])
    return build + work.topk_flops(len(problem.test_users), problem.n_items,
                                   opts["rank"])
