"""The port's mesh: a ``torch.distributed`` process group with one rank per
card, and the named axis sizes laid over it (counterpart of
``evotorch_tpu/parallel/mesh.py``).

The JAX package's mesh is one process driving many devices. The port's is
one process per card, each running the same program (SPMD over processes):
NCCL joins them on the cards, gloo on the CPU. One host thread driving N
cards would not do here: the evaluation is launch-bound (about 2,800
kernel launches per ``budget`` control step, the card idle more than 90% of
the time, ``PERF.md`` §5), so a single thread driving N cards would issue N
times the launches from one CPU core instead of spreading them over N.

Where the JAX package reads ``jax.device_count()``, the port reads the
group's world size (``device_count``). With no group initialized the world
size is 1 and every sharded entry point runs the unsharded path.

Population rows are laid over all axes flattened (``population_spec``), so
a ``model`` axis shards rows like ``pop``. The JAX package additionally
storage-shards a trunk-delta population's L-sized trunk arrays over
``model``; the port keeps them replicated on every rank (same results, more
memory).

A ``Mesh`` also carries the collectives the sharded paths use. Every one
of them is an ``all_reduce``: gloo carries ``all_reduce`` for CUDA tensors
but not ``all_gather``, and NCCL refuses two ranks on one card, so rows
are gathered by summing a zero-filled global buffer in which each rank
wrote its own rows. One code path then serves both backends.
"""

from __future__ import annotations

import math
import os
from typing import Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "MESH_AXES",
    "Mesh",
    "as_mesh",
    "default_mesh",
    "device_count",
    "make_mesh",
    "mesh_label",
    "model_axis_size",
    "num_actors_mesh",
    "parse_mesh_shape",
]

#: the named axes: ``"pop"`` shards the population, ``"model"`` is the JAX
#: package's model axis (rows are laid over both here, see the module note)
MESH_AXES = ("pop", "model")


def _world(group=None) -> int:
    if not (dist.is_available() and dist.is_initialized()):
        return 1
    return dist.get_world_size(group)


def device_count() -> int:
    """The world size of the default process group (1 without one): the
    port's count of cards, one rank per card."""
    return _world()


class Mesh:
    """Named axis sizes over a process group (``group=None``: the default
    group). Their product must be the group's world size: every rank holds
    one shard. ``rank`` is this process's shard index."""

    def __init__(self, axis_shape: dict, group=None):
        shape = {str(k): int(v) for k, v in axis_shape.items()}
        if not shape or any(v < 1 for v in shape.values()):
            raise ValueError(f"a mesh needs axes of size >= 1, got {axis_shape!r}")
        world = _world(group)
        size = math.prod(shape.values())
        if size != world:
            raise ValueError(
                f"the mesh {shape} has {size} shards but the process group has {world} ranks;"
                " the port lays one shard on every rank (launch that many ranks, e.g. torchrun --nproc-per-node)"
            )
        self.shape = shape
        self.group = group
        self.size = size
        self.distributed = dist.is_available() and dist.is_initialized()
        self.rank = dist.get_rank(group) if self.distributed else 0

    @property
    def axis_names(self) -> tuple:
        return tuple(self.shape)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, rank={self.rank})"

    # ------------------------------------------------------------- layout
    def block(self, n: int) -> tuple:
        """This rank's rows of an ``n``-row population: ``(start, stop,
        per_rank)``; the population is padded to ``per_rank * size`` rows,
        this rank holding global rows ``[rank * per_rank, (rank + 1) *
        per_rank)``, of which ``[start, stop)`` are real."""
        per = -(-int(n) // self.size)
        start = min(self.rank * per, int(n))
        return start, min(start + per, int(n)), per

    # -------------------------------------------------------- collectives
    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.clone()
        if self.distributed:
            dist.all_reduce(t, op=op, group=self.group)
        return t

    def all_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks (a new tensor)."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_max(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MAX)

    def all_min(self, t: torch.Tensor) -> torch.Tensor:
        return self._reduce(t, dist.ReduceOp.MIN)

    def gather_rows(self, local: torch.Tensor, total: int, start: int) -> torch.Tensor:
        """Every rank's rows in one ``(total, ...)`` tensor: a zero-filled
        buffer in which this rank wrote ``local`` at ``start``, summed over
        ranks (exact: every other rank adds zeros)."""
        if not self.distributed:
            return local
        buf = torch.zeros((int(total),) + tuple(local.shape[1:]), dtype=local.dtype, device=local.device)
        buf[start : start + local.shape[0]] = local
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf


def as_mesh(mesh_or_group) -> Mesh:
    """A ``Mesh`` as it is, or a 1-D ``pop`` mesh over a process group."""
    if isinstance(mesh_or_group, Mesh):
        return mesh_or_group
    return Mesh({"pop": _world(mesh_or_group)}, group=mesh_or_group)


def num_actors_mesh(request, popsize: Optional[int] = None, *, divisible: bool = False) -> Optional[Mesh]:
    """The mesh a ``num_actors`` request asks for: ``"max"`` (or
    ``"num_devices"``, ``"num_gpus"``, ``"num_cpus"``) every rank of the
    default group, a number at most that many. None (the unsharded path)
    without a process group when one shard is asked for, and for a request
    of 1. The port lays one shard on every rank, so a request for fewer
    shards than ranks raises. ``divisible``: the paths that need the
    popsize to divide over the shards step down to the largest count that
    divides it, as in the JAX package; below the world size that too
    raises, unless it reaches 1."""
    if isinstance(request, str) and request not in ("max", "num_devices", "num_gpus", "num_cpus"):
        raise ValueError(f"Unrecognized num_actors request: {request!r}")
    world = device_count()
    n = world if isinstance(request, str) else max(1, min(int(request), world))
    if divisible and popsize is not None:
        while int(popsize) % n != 0:
            n -= 1
    if n == 1 and (world == 1 and not dist.is_initialized() or request == 1):
        return None
    if n < world:
        if n == 1:
            return None
        raise ValueError(
            f"num_actors={request!r} asks for {n} shards in a process group of {world} ranks; the port lays one shard"
            " on every rank: launch that many ranks"
        )
    return default_mesh()


def default_mesh(axis_names: Sequence[str] = ("pop",), group=None) -> Mesh:
    """A 1-D mesh over every rank of ``group`` (the default group)."""
    if len(axis_names) != 1:
        raise ValueError("default_mesh creates 1-D meshes; use make_mesh for N-D")
    return Mesh({axis_names[0]: _world(group)}, group=group)


def make_mesh(axis_shape: dict, group=None) -> Mesh:
    """An N-D mesh from ``{axis_name: size}``, e.g. ``make_mesh({"pop": 4,
    "model": 2})`` over 8 ranks. The sizes must multiply to the world
    size."""
    total = math.prod(int(s) for s in axis_shape.values())
    if total > _world(group):
        raise ValueError(f"Mesh needs {total} ranks, but only {_world(group)} are in the process group")
    return Mesh(axis_shape, group=group)


def _hosts() -> int:
    """Hosts of a ``torchrun`` job: the world over the ranks of one host."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE", "0") or 0)
    world = device_count()
    return world // local if local > 0 and world % local == 0 else 1


def mesh_label(mesh) -> str:
    """The canonical label of a mesh shape (a ``Mesh`` or an ``{axis:
    size}`` dict): ``"none"`` unsharded, ``"pop8"``, ``"pop4.model2"``; size-1
    axes dropped, an all-1 mesh ``"none"``, and a ``"hosts{n}."`` prefix when
    the job spans several hosts. The JAX package's labels, value for value."""
    if mesh is None:
        return "none"
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    parts = [f"{name}{size}" for name, size in shape.items() if int(size) > 1]
    label = ".".join(parts) if parts else "none"
    hosts = _hosts()
    if hosts > 1:
        label = f"hosts{hosts}.{label}"
    return label


def model_axis_size(mesh) -> int:
    """Size of the mesh's ``model`` axis, 1 when absent (or no mesh)."""
    if mesh is None:
        return 1
    shape = mesh.shape if isinstance(mesh, Mesh) else dict(mesh)
    return int(shape.get("model", 1))


def parse_mesh_shape(spec) -> dict:
    """Parse a mesh-shape knob into ``{axis: size}``: ``"8"`` / ``8`` ->
    ``{"pop": 8}``; ``"4x2"`` -> ``{"pop": 4, "model": 2}``;
    ``"pop=4,model=2"`` -> the same with explicit names."""
    if isinstance(spec, int):
        return {"pop": int(spec)}
    text = str(spec).strip()
    if "=" in text:
        out = {}
        for part in text.split(","):
            name, _, size = part.partition("=")
            out[name.strip()] = int(size)
        return out
    if "x" in text:
        sizes = [int(p) for p in text.split("x")]
        if len(sizes) > len(MESH_AXES):
            raise ValueError(f"mesh shape {text!r} has {len(sizes)} axes; named axes are {MESH_AXES}")
        return {name: size for name, size in zip(MESH_AXES, sizes)}
    return {"pop": int(text)}
