"""Device meshes driven by one process.

Counterpart of :mod:`polara_tpu.runtime.mesh`.  The JAX package is
single-controller: one process drives a ``jax.sharding.Mesh`` and GSPMD
inserts the collectives.  Here one process drives a grid of
``torch.device`` entries: a sharded computation is a loop over shards with
each shard's work on its own device, and the collectives are copies to
one device followed by a sum (:func:`psum`) or a concatenation
(:func:`all_gather`), always in shard order.

Test users and training-matrix rows shard over the first axis
(``users``); the fused scoring route may shard the item panel over the
second (``model``).  Entries may repeat: a mesh whose entries are all
``cuda:0`` runs every shard on one card at full width, and a mesh of
repeated ``cpu`` entries is the CPU tests' counterpart of the JAX tests'
virtual devices.  Where the JAX package scales a per-device memory
budget by the mesh size, the port scales it by the number of distinct
devices that hold shards (:func:`shard_device_count`), so a mesh of
repeated entries budgets for the one device it has.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import (Callable, Dict, Iterator, List, NamedTuple, Optional,
                    Sequence, Tuple, Union)

import numpy as np
import torch

DeviceLike = Union[str, torch.device]


class Mesh:
    """An n-d grid of ``torch.device`` entries with named axes.

    Hashable and compared by value (axis names, grid shape and entries),
    so equal meshes share the memoized scoring steps and the dense-block
    cache entries keyed on them."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str]):
        entries = np.asarray(devices, dtype=object)
        shape = entries.shape
        flat = [torch.device(d) for d in entries.flat]
        grid = np.empty(len(flat), dtype=object)
        grid[:] = flat
        self.axis_names: Tuple[str, ...] = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh grid of shape {shape} needs "
                             f"{len(shape)} axis names, got "
                             f"{self.axis_names}")
        self.devices: np.ndarray = grid.reshape(shape)
        self._key = (self.axis_names, shape, tuple(flat))

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def __eq__(self, other) -> bool:
        return isinstance(other, Mesh) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        grid = np.vectorize(str, otypes=[object])(self.devices).tolist()
        return f"Mesh({grid}, axis_names={self.axis_names})"


# The framework-wide default mesh: models built or scored without an
# explicit ``mesh=`` run distributed over it when it is set.
_DEFAULT_MESH: Optional[Mesh] = None


def set_default_mesh(mesh: Optional[Mesh]) -> None:
    """Install (or clear, with ``None``) the framework-wide default mesh."""
    global _DEFAULT_MESH
    _DEFAULT_MESH = mesh


def get_default_mesh() -> Optional[Mesh]:
    return _DEFAULT_MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Scoped default mesh: models without an explicit ``mesh=`` that build
    or score inside the block run distributed over it."""
    global _DEFAULT_MESH
    saved = _DEFAULT_MESH
    _DEFAULT_MESH = mesh
    try:
        yield mesh
    finally:
        _DEFAULT_MESH = saved


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("users", "model"),
              shape: Optional[Sequence[int]] = None,
              devices: Optional[Sequence[DeviceLike]] = None) -> Mesh:
    """A mesh over ``devices`` (default: every visible CUDA card; without
    one it raises, it never turns into the CPU).

    By default every entry goes onto the ``users`` axis with trivial
    further axes.  ``devices`` may repeat an entry (``["cpu"] * 8``, or
    ``["cuda:0"] * 4`` on a one-card machine)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is available; pass devices= "
                "(e.g. [\"cpu\"] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    if shape is None:
        shape = (n,) + (1,) * (len(axes) - 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} does not cover {n} "
                         "devices")
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(tuple(shape)), axes)


class Placement(NamedTuple):
    """Where a tensor's dimensions go on a mesh: ``spec[d]`` names the mesh
    axis that dimension ``d`` splits over (None: every entry holds it
    whole); an empty spec is a replicated tensor.

    Kept for name parity with the JAX package's ``NamedSharding``
    helpers: no code of the port reads a placement, the sharded routes
    place their tensors through :func:`shard_rows` and the mesh's
    device grid."""
    mesh: Mesh
    spec: Tuple[Optional[str], ...]


def user_sharding(mesh: Mesh) -> Placement:
    """Rows split over the ``users`` axis, columns whole."""
    return Placement(mesh, (mesh.axis_names[0], None))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh, ())


def pad_to_multiple(n: int, multiple: int) -> int:
    return -(-n // multiple) * multiple


def device_grid(mesh: Mesh) -> np.ndarray:
    """The (users, model) grid of devices: entry ``[i, j]`` runs users
    shard i's slice j of the ``model`` axis.  A mesh with one axis has one
    column; further axes split nothing and give their first entry."""
    shape = mesh.devices.shape
    n_model = shape[1] if len(shape) > 1 else 1
    return mesh.devices.reshape(shape[0], n_model, -1)[:, :, 0]


def users_devices(mesh: Mesh) -> List[torch.device]:
    """The device of each users-axis shard, in shard order: the first
    column of :func:`device_grid` (a row-sharded tensor is held once per
    users shard, not once per entry)."""
    return list(device_grid(mesh)[:, 0])


def shard_device_count(mesh: Mesh) -> int:
    """The number of distinct devices that hold users shards: what a
    per-device memory budget scales by for a row-sharded block (1 for a
    mesh whose entries all repeat one device)."""
    return len(set(users_devices(mesh)))


def psum(parts: Sequence[torch.Tensor],
         device: Optional[DeviceLike] = None) -> torch.Tensor:
    """Sum of per-shard partials: each is copied to ``device`` (default:
    the first part's) and added in shard order."""
    device = parts[0].device if device is None else torch.device(device)
    total = parts[0].to(device)
    for part in parts[1:]:
        total = total + part.to(device)
    return total


def all_gather(parts: Sequence[torch.Tensor],
               device: Optional[DeviceLike] = None,
               dim: int = 0) -> torch.Tensor:
    """Per-shard parts copied to ``device`` (default: the first part's) and
    concatenated along ``dim`` in shard order."""
    device = parts[0].device if device is None else torch.device(device)
    return torch.cat([part.to(device) for part in parts], dim=dim)


@dataclasses.dataclass(frozen=True, eq=False)
class ShardedRows:
    """A 2-D tensor split into equal row blocks, one per users-axis shard in
    shard order, each on its shard's device.  Rows are zero-padded up to a
    multiple of the shard count; ``n_rows`` is the true row count.

    The first block's device is the home device: collectives land there.
    """
    blocks: Tuple[torch.Tensor, ...]
    n_rows: int

    @property
    def shape(self) -> Tuple[int, ...]:
        return ((sum(b.shape[0] for b in self.blocks),)
                + tuple(self.blocks[0].shape[1:]))

    @property
    def dtype(self) -> torch.dtype:
        return self.blocks[0].dtype

    @property
    def device(self) -> torch.device:
        return self.blocks[0].device

    def map(self, fn: Callable[[torch.Tensor], torch.Tensor]
            ) -> "ShardedRows":
        """``fn`` applied to each block on its own device."""
        return ShardedRows(tuple(fn(b) for b in self.blocks), self.n_rows)

    def __matmul__(self, other: torch.Tensor) -> "ShardedRows":
        """Each block times a replicated (small) matrix."""
        return self.map(lambda b: b @ other.to(b.device))

    def gather(self, device: Optional[DeviceLike] = None) -> torch.Tensor:
        """The whole tensor on ``device`` (default: home), padding rows
        dropped."""
        return all_gather(self.blocks, device)[:self.n_rows]


def shard_rows(tensor: torch.Tensor, mesh: Mesh) -> ShardedRows:
    """Split a 2-D tensor's rows over the mesh ``users`` axis.

    Rows are zero-padded up to a multiple of the axis size (callers carry
    the true row count and drop the padding from their results).  Blocks
    that lie on the tensor's device are views of it; only a block that
    needs padding is a new tensor."""
    devices = users_devices(mesh)
    n = tensor.shape[0]
    per = pad_to_multiple(n, len(devices)) // len(devices)
    blocks = []
    for i, device in enumerate(devices):
        block = tensor[i * per:(i + 1) * per]
        if block.shape[0] < per:
            fill = block.new_zeros((per - block.shape[0],)
                                   + tuple(tensor.shape[1:]))
            block = torch.cat([block, fill])
        blocks.append(block.to(device))
    return ShardedRows(tuple(blocks), n)
