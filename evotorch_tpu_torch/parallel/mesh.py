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
a ``model`` axis shards rows like ``pop``. A trunk-delta population's
L-sized trunk arrays are stored sharded over ``model``, as in the JAX
package: each rank keeps its ``1/m`` slice at rest and gathers the whole
trunk for the length of a rollout (``shard_trunk``, ``gather_trunk``).

A ``num_actors`` request for fewer shards than ranks builds a mesh over
the first n ranks (a sub-group of the default group, made once per n):
those ranks evaluate, the others skip the work, and ``spread`` hands the
members' results to every rank of the default group.

A ``Mesh`` also carries the collectives the sharded paths use. Every one
of them is an ``all_reduce``: gloo carries ``all_reduce`` for CUDA tensors
but not ``all_gather``, and NCCL refuses two ranks on one card, so rows
are gathered by summing a zero-filled global buffer in which each rank
wrote its own rows. One code path then serves both backends.
"""

from __future__ import annotations

import math
import os
from typing import Any, NamedTuple, Optional, Sequence

import torch
import torch.distributed as dist

__all__ = [
    "MESH_AXES",
    "Mesh",
    "TrunkShard",
    "as_mesh",
    "default_mesh",
    "device_count",
    "gather_trunk",
    "make_mesh",
    "mesh_label",
    "model_axis_size",
    "num_actors_mesh",
    "parse_mesh_shape",
    "shard_trunk",
    "sub_mesh",
    "trunk_nbytes",
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
    one shard. ``rank`` is this process's shard index. A mesh over a
    sub-group (``sub_mesh``) exists on every rank of the default group; on
    the ranks outside it ``member`` is False and ``rank`` is -1."""

    def __init__(self, axis_shape: dict, group=None):
        shape = {str(k): int(v) for k, v in axis_shape.items()}
        if not shape or any(v < 1 for v in shape.values()):
            raise ValueError(f"a mesh needs axes of size >= 1, got {axis_shape!r}")
        self.distributed = dist.is_available() and dist.is_initialized()
        self.member = not self.distributed or group is None or dist.get_rank(group) >= 0
        world = _world(group) if self.member else math.prod(shape.values())
        size = math.prod(shape.values())
        if size != world:
            raise ValueError(
                f"the mesh {shape} has {size} shards but the process group has {world} ranks;"
                " the port lays one shard on every rank (launch that many ranks, e.g. torchrun --nproc-per-node)"
            )
        self.shape = shape
        self.group = group
        self.size = size
        self.rank = dist.get_rank(group) if self.distributed else 0
        #: a mesh over the first ranks (``sub_mesh``), whose results the
        #: other ranks of the default group take through ``spread``
        self.partial = False

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

    def spread(self, tensors: Sequence[torch.Tensor]) -> list:
        """The members' tensors on every rank of the default group. Every
        rank passes tensors of the same shapes and dtypes (the members their
        results, the others placeholders); the mesh's rank 0 writes its
        bytes into a zero-filled buffer, summed over the default group in
        one ``all_reduce`` (exact: every other rank adds zeros). Any other
        mesh returns the tensors as they are."""
        tensors = list(tensors)
        if not self.partial:
            return tensors
        sizes = [t.numel() * t.element_size() for t in tensors]
        offsets = [0]
        for size in sizes:
            offsets.append(offsets[-1] + -(-size // 8) * 8)  # 8-byte aligned segments
        buf = torch.zeros((offsets[-1],), dtype=torch.uint8, device=tensors[0].device)
        if self.rank == 0:
            for t, lo, size in zip(tensors, offsets, sizes):
                buf[lo : lo + size] = t.detach().contiguous().reshape(-1).view(torch.uint8)
        dist.all_reduce(buf, op=dist.ReduceOp.SUM)
        return [
            buf[lo : lo + size].view(t.dtype).reshape(t.shape).clone() for t, lo, size in zip(tensors, offsets, sizes)
        ]


def as_mesh(mesh_or_group) -> Mesh:
    """A ``Mesh`` as it is, or a 1-D ``pop`` mesh over a process group."""
    if isinstance(mesh_or_group, Mesh):
        return mesh_or_group
    return Mesh({"pop": _world(mesh_or_group)}, group=mesh_or_group)


_SUB_MESHES: dict = {}


def sub_mesh(n: int) -> Mesh:
    """A 1-D ``pop`` mesh over the first ``n`` ranks of the default group,
    made once per ``n`` (``dist.new_group`` is a
    collective call: every rank makes the same calls in the same order, so
    every rank calls this for the same ``n`` at the same point)."""
    n = int(n)
    world = device_count()
    if n >= world:
        return default_mesh()
    key = (id(dist.group.WORLD), n)
    mesh = _SUB_MESHES.get(key)
    if mesh is None:
        mesh = _SUB_MESHES[key] = Mesh({"pop": n}, group=dist.new_group(list(range(n))))
        mesh.partial = True
    return mesh


def num_actors_mesh(request, popsize: Optional[int] = None, *, divisible: bool = False) -> Optional[Mesh]:
    """The mesh a ``num_actors`` request asks for: ``"max"`` (or
    ``"num_devices"``, ``"num_gpus"``, ``"num_cpus"``) every rank of the
    default group, a number at most that many: fewer than the ranks gives a
    mesh over the first n (``sub_mesh``). None (the unsharded path) for one
    shard. ``divisible``: the paths that need the popsize to divide over the
    shards step down to the largest count that divides it, as in the JAX
    package."""
    if isinstance(request, str) and request not in ("max", "num_devices", "num_gpus", "num_cpus"):
        raise ValueError(f"Unrecognized num_actors request: {request!r}")
    world = device_count()
    n = world if isinstance(request, str) else max(1, min(int(request), world))
    if divisible and popsize is not None:
        while int(popsize) % n != 0:
            n -= 1
    if n == 1 and (world > 1 or not dist.is_initialized() or request == 1):
        return None
    return sub_mesh(n)


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


class TrunkShard(NamedTuple):
    """A trunk-delta population at rest on one rank of a mesh with a
    ``model`` axis of size m: this rank's slice of the L-sized trunk arrays
    (the center and the effective basis, padded to ``ceil(L / m) * m`` rows
    and cut in m slices along the model axis), with the per-lane
    coefficients and the factors whole. ``gather_trunk`` rebuilds the
    ``TrunkDeltaParamsBatch``."""

    center: torch.Tensor  # (ceil(L / m),)
    basis: torch.Tensor  # (ceil(L / m), k)
    coeffs: torch.Tensor  # (N, k)
    factors: Any
    length: int  # L

    @property
    def popsize(self) -> int:
        return int(self.coeffs.shape[0])


def _model_coordinate(mesh: Mesh) -> tuple:
    """This rank's index along ``model`` and whether its other coordinates
    are all 0 (the one rank that writes its slice in a gather)."""
    stride = 1
    for name in reversed(mesh.axis_names):
        if name == "model":
            break
        stride *= mesh.shape[name]
    index = (mesh.rank // stride) % model_axis_size(mesh)
    return index, mesh.rank == index * stride


def shard_trunk(values, mesh: Mesh):
    """A ``TrunkDeltaParamsBatch`` as this rank keeps it at rest on
    ``mesh``: a ``TrunkShard`` holding a copy of its ``1/m`` slice of the
    trunk arrays (so the whole ones can be freed). Anything else, or a mesh
    without a ``model`` axis, is returned as it is."""
    from ..tools.lowrank import TrunkDeltaParamsBatch

    m = model_axis_size(mesh)
    if m == 1 or not isinstance(values, TrunkDeltaParamsBatch):
        return values
    length = int(values.center.shape[0])
    per = -(-length // m)
    index, _ = _model_coordinate(mesh)
    lo, hi = min(index * per, length), min((index + 1) * per, length)
    center = torch.zeros((per,), dtype=values.center.dtype, device=values.center.device)
    basis = torch.zeros((per, values.basis.shape[1]), dtype=values.basis.dtype, device=values.basis.device)
    center[: hi - lo] = values.center[lo:hi]
    basis[: hi - lo] = values.basis[lo:hi]
    return TrunkShard(center, basis, values.coeffs, values.factors, length)


def gather_trunk(shard: TrunkShard, mesh: Mesh):
    """The whole ``TrunkDeltaParamsBatch`` of a ``TrunkShard``, in a new
    buffer: one rank of each model slice writes it into a zero-filled
    ``(ceil(L / m) * m, 1 + k)`` buffer, summed over the mesh in one
    ``all_reduce`` (exact)."""
    from ..tools.lowrank import TrunkDeltaParamsBatch

    m = model_axis_size(mesh)
    per, k = shard.basis.shape
    index, writes = _model_coordinate(mesh)
    buf = torch.zeros((per * m, 1 + k), dtype=shard.basis.dtype, device=shard.basis.device)
    if writes:
        buf[index * per : (index + 1) * per, 0] = shard.center
        buf[index * per : (index + 1) * per, 1:] = shard.basis
    if mesh.distributed:
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=mesh.group)
    whole = buf[: shard.length]
    return TrunkDeltaParamsBatch(whole[:, 0].contiguous(), whole[:, 1:].contiguous(), shard.coeffs, shard.factors)


def trunk_nbytes(values) -> int:
    """The bytes of a trunk-delta population's trunk arrays as held (the
    center and the basis; a ``TrunkShard``'s slices)."""
    return values.center.numel() * values.center.element_size() + values.basis.numel() * values.basis.element_size()


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
