"""Matrix-factorization training (SGD family).

Counterpart of :mod:`polara_tpu.ops.factorize` (the reference's Numba SGD
sweeps, ``polara/lib/optimize.py:9-301``): shuffled **minibatch SGD**.
Each step gathers the factor rows of a batch, computes all residuals at
once and scatter-adds per-row gradient sums (``index_add_``).  Semantics
kept from the JAX package:

* loss: squared error with per-occurrence L2 (``lambd``), optionally
  normalized by row/col nnz counts (``generalized``);
* optional kernel-smoothed regularization for KPMF
  (:class:`KernelOperator`), with the reference's double-counted diagonal;
* per-epoch RMSE history and relative-improvement early stopping.

The JAX package trains with ``optax``; the port writes the seven
optimizers by hand with optax's formulas (:func:`_make_optimizer`), so a
step of each equals optax's on the same gradients.  The epoch permutation
and the initial factors come from a ``torch.Generator`` on the device (a
different stream from ``jax.random``), so trained models agree with the
JAX package's in their end metrics, not their bits.  On the card the
scatter-adds run on atomics: two runs may differ in the last bits.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, List, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from polara_tpu_torch.runtime.device import resolve_device
from polara_tpu_torch.runtime.rng import generator_from_seed

Params = Tuple[torch.Tensor, ...]


class MFState(NamedTuple):
    p: torch.Tensor          # (n_rows, rank)
    q: torch.Tensor          # (n_cols, rank)
    opt_state: tuple


@dataclasses.dataclass
class MFResult:
    p: torch.Tensor
    q: torch.Tensor
    rmse_history: List[float]


class GradientTransformation(NamedTuple):
    """``init(params) -> state`` and ``update(grads, state) -> (updates,
    state)`` over tuples of tensors (optax's interface); apply an update
    with :func:`apply_updates`."""
    init: Callable
    update: Callable


def apply_updates(params: Params, updates: Params) -> Params:
    return tuple(p + u for p, u in zip(params, updates))


def _sgd(lrate: float) -> GradientTransformation:
    def update(grads, state):
        return tuple(-lrate * g for g in grads), state
    return GradientTransformation(lambda params: (), update)


def _adagrad(lrate: float, eps: float = 1e-6,
             initial_accumulator_value: float = 0.1
             ) -> GradientTransformation:
    """``optax.adagrad``: the squared-gradient sum starts at 0.1 and
    ``eps`` sits inside the root; the update is 0 where the sum is 0."""
    def init(params):
        return tuple(torch.full_like(p, initial_accumulator_value)
                     for p in params)

    def update(grads, state):
        sums = tuple(g * g + s for g, s in zip(grads, state))
        updates = tuple(
            -lrate * (torch.where(s > 0, torch.rsqrt(s + eps), 0.0) * g)
            for g, s in zip(grads, sums))
        return updates, sums
    return GradientTransformation(init, update)


def _rmsprop(lrate: float, decay: float = 0.9,
             eps: float = 1e-6) -> GradientTransformation:
    """``optax.rmsprop`` (uncentered, no momentum): an EMA of squared
    gradients from 0, ``eps`` inside the root (optax's ``eps_in_sqrt``
    default)."""
    def init(params):
        return tuple(torch.zeros_like(p) for p in params)

    def update(grads, state):
        nus = tuple((1 - decay) * (g * g) + decay * n
                    for g, n in zip(grads, state))
        updates = tuple(-lrate * (torch.rsqrt(n + eps) * g)
                        for g, n in zip(grads, nus))
        return updates, nus
    return GradientTransformation(init, update)


def _adam(lrate: float, b1: float = 0.9, b2: float = 0.999,
          eps: float = 1e-6) -> GradientTransformation:
    """``optax.adam``: bias-corrected moments, ``eps`` outside the root."""
    def init(params):
        return (0, tuple(torch.zeros_like(p) for p in params),
                tuple(torch.zeros_like(p) for p in params))

    def update(grads, state):
        count, mus, nus = state
        count += 1
        mus = tuple((1 - b1) * g + b1 * m for g, m in zip(grads, mus))
        nus = tuple((1 - b2) * (g * g) + b2 * n for g, n in zip(grads, nus))
        c1, c2 = 1 - b1 ** count, 1 - b2 ** count
        updates = tuple(-lrate * ((m / c1) / (torch.sqrt(n / c2) + eps))
                        for m, n in zip(mus, nus))
        return updates, (count, mus, nus)
    return GradientTransformation(init, update)


def _rowwise_norm_optimizer(kind: str, lrate: float, gamma: float = 0.99,
                            smoothing: float = 1e-6
                            ) -> GradientTransformation:
    """Per-row gradient-norm adjusters of the reference
    (``polara/lib/optimize.py:102-120``): adanorm (instant row-norm),
    gnprop (EMA of squared row norms), gnpropz (cumulative).  State rows
    only advance when the row received gradient this step."""

    def init(params):
        if kind == "adanorm":
            return ()
        return tuple(p.new_zeros(p.shape[:-1]) for p in params)

    def update(grads, state):
        norms2 = tuple(torch.sum(g * g, dim=-1) for g in grads)
        if kind == "adanorm":
            denom = norms2
            new_state = state
        else:
            def advance(s, n2):
                if kind == "gnprop":
                    stepped = gamma * s + (1.0 - gamma) * n2
                else:  # gnpropz
                    stepped = s + n2
                return torch.where(n2 > 0, stepped, s)
            new_state = tuple(advance(s, n2) for s, n2 in zip(state, norms2))
            denom = new_state
        updates = tuple(-lrate * g / torch.sqrt(smoothing + d)[..., None]
                        for g, d in zip(grads, denom))
        return updates, new_state

    return GradientTransformation(init, update)


def _make_optimizer(name: str, lrate: float) -> GradientTransformation:
    if name == "sgd":
        return _sgd(lrate)
    if name == "adagrad":
        return _adagrad(lrate, eps=1e-6)
    if name == "rmsprop":
        return _rmsprop(lrate, decay=0.9, eps=1e-6)
    if name == "adam":
        return _adam(lrate, b1=0.9, b2=0.999, eps=1e-6)
    if name in ("adanorm", "gnprop", "gnpropz"):
        return _rowwise_norm_optimizer(name, lrate)
    raise ValueError(f"Unknown optimizer {name!r}; expected sgd/adagrad/"
                     "rmsprop/adam/adanorm/gnprop/gnpropz")


def _batch_grads(p, q, rows, cols, vals, weight, lambd,
                 row_inv_nnz, col_inv_nnz, row_kernel, col_kernel):
    """Gradient sums of one minibatch, scatter-added per factor row.

    ``weight`` zeroes padded entries.  Returns (grad_p, grad_q, sq_error).
    """
    pi = p[rows]
    qj = q[cols]
    err = (vals - torch.sum(pi * qj, dim=1)) * weight

    # data-term gradients (d/dp of -err contribution)
    gp = -err[:, None] * qj
    gq = -err[:, None] * pi

    # regularization, per occurrence, scaled by 1/nnz when generalized
    if row_kernel is not None:
        reg_rows = row_kernel(p)[rows] + row_kernel.diag[rows, None] * pi
    else:
        reg_rows = pi
    if col_kernel is not None:
        reg_cols = col_kernel(q)[cols] + col_kernel.diag[cols, None] * qj
    else:
        reg_cols = qj
    gp = gp + (lambd * row_inv_nnz[rows] * weight)[:, None] * reg_rows
    gq = gq + (lambd * col_inv_nnz[cols] * weight)[:, None] * reg_cols

    grad_p = torch.zeros_like(p).index_add_(0, rows, gp)
    grad_q = torch.zeros_like(q).index_add_(0, cols, gq)
    return grad_p, grad_q, torch.sum(err * err)


@dataclasses.dataclass(frozen=True)
class KernelOperator:
    """Dense symmetric kernel for KPMF regularization."""
    matrix: torch.Tensor     # (n, n)
    diag: torch.Tensor       # (n,)

    def __call__(self, factors: torch.Tensor) -> torch.Tensor:
        return self.matrix @ factors

    @classmethod
    def from_dense(cls, matrix: torch.Tensor) -> "KernelOperator":
        return cls(matrix=matrix, diag=torch.diagonal(matrix))


ArrayLike = Union[np.ndarray, torch.Tensor]


def _on_device(x: ArrayLike, device: torch.device,
               dtype: torch.dtype) -> torch.Tensor:
    return torch.as_tensor(x).to(device=device, dtype=dtype)


def _input_device(device, data: ArrayLike, entry_point: str) -> torch.device:
    """The device a trainer runs on: ``device`` if given, else that of a
    tensor input, else the card (:func:`resolve_device`)."""
    if device is None and isinstance(data, torch.Tensor):
        return data.device
    return resolve_device(device, entry_point)


def mf_train(rows: ArrayLike, cols: ArrayLike, vals: ArrayLike,
             shape: Tuple[int, int], rank: int,
             lrate: float = 0.005, lambd: float = 0.5,
             num_epochs: int = 25, tol: float = 1e-4,
             batch_size: int = 8192,
             optimizer: str = "sgd",
             generalized: bool = False,
             row_nnz: Optional[np.ndarray] = None,
             col_nnz: Optional[np.ndarray] = None,
             row_kernel: Optional[KernelOperator] = None,
             col_kernel: Optional[KernelOperator] = None,
             seed: Optional[int] = None,
             dtype: torch.dtype = torch.float32,
             verbose: bool = False,
             iter_errors: Optional[List[float]] = None,
             iter_time: Optional[List[float]] = None,
             device=None,
             init: Optional[Tuple[ArrayLike, ArrayLike]] = None
             ) -> MFResult:
    """Train P, Q such that ``vals ~= sum(P[rows] * Q[cols])``.

    ``rows``/``cols``/``vals`` are numpy arrays or tensors; the training
    runs on ``device`` (default: the inputs' device for tensors, else the
    card).  The stream pads to whole batches as ``np.resize`` does,
    repeating it from its start, and the repeated entries weigh 0.
    ``init``: an optional start ``(P, Q)``; without it, ``0.1 N(0, 1)``
    draws from a ``torch.Generator`` seeded by ``seed`` (the epochs'
    permutations come from that generator either way)."""
    device = _input_device(device, rows, "mf_train")
    n_rows, n_cols = (int(s) for s in shape)
    nnz = len(vals)
    n_batches = max(1, -(-nnz // batch_size))
    padded = n_batches * batch_size

    wrap = torch.arange(padded, device=device) % nnz      # np.resize
    rows_d = _on_device(rows, device, torch.int64)[wrap]
    cols_d = _on_device(cols, device, torch.int64)[wrap]
    vals_d = _on_device(vals, device, dtype)[wrap]
    weight_d = (torch.arange(padded, device=device) < nnz).to(dtype)

    if generalized:
        def inverse_counts(index, n, given):
            counts = (torch.bincount(index[:nnz], minlength=n)
                      if given is None else torch.as_tensor(given))
            return (1.0 / counts.double().clamp(min=1)).to(device=device,
                                                          dtype=dtype)
        row_inv = inverse_counts(rows_d, n_rows, row_nnz)
        col_inv = inverse_counts(cols_d, n_cols, col_nnz)
    else:
        row_inv = torch.ones((n_rows,), dtype=dtype, device=device)
        col_inv = torch.ones((n_cols,), dtype=dtype, device=device)

    opt = _make_optimizer(optimizer, lrate)
    gen = generator_from_seed(seed, device)
    if init is None:
        p = 0.1 * torch.randn((n_rows, rank), generator=gen, dtype=dtype,
                              device=device)
        q = 0.1 * torch.randn((n_cols, rank), generator=gen, dtype=dtype,
                              device=device)
    else:
        p, q = (_on_device(x, device, dtype) for x in init)
    state = MFState(p=p, q=q, opt_state=opt.init((p, q)))

    def run_epoch(state: MFState) -> Tuple[MFState, torch.Tensor]:
        perm = torch.randperm(padded, generator=gen, device=device)
        batches = (rows_d[perm].view(n_batches, batch_size),
                   cols_d[perm].view(n_batches, batch_size),
                   vals_d[perm].view(n_batches, batch_size),
                   weight_d[perm].view(n_batches, batch_size))
        sq_total = torch.zeros((), dtype=dtype, device=device)
        for b_rows, b_cols, b_vals, b_w in zip(*batches):
            gp, gq, sq_err = _batch_grads(
                state.p, state.q, b_rows, b_cols, b_vals, b_w, lambd,
                row_inv, col_inv, row_kernel, col_kernel)
            updates, opt_state = opt.update((gp, gq), state.opt_state)
            p, q = apply_updates((state.p, state.q), updates)
            state = MFState(p, q, opt_state)
            sq_total = sq_total + sq_err
        return state, sq_total

    rmse_history = [] if iter_errors is None else iter_errors
    last_err = np.finfo(np.float64).max
    for epoch in range(num_epochs):
        t0 = time.perf_counter()
        state, sq_err = run_epoch(state)
        sq_err = float(sq_err)          # one sync per epoch
        if iter_time is not None:
            iter_time.append(time.perf_counter() - t0)
        rmse = float(np.sqrt(sq_err / nnz))
        rmse_history.append(rmse)
        if verbose:
            print(f"Epoch: {epoch}. RMSE: {rmse}")
        improvement = abs(last_err - sq_err) / last_err
        last_err = sq_err
        if improvement < tol:
            break
    return MFResult(p=state.p, q=state.q, rmse_history=rmse_history)
