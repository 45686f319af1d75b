"""Vectorization-friendly batched data structures (counterpart of
``evotorch_tpu/tools/structures.py``).

``CMemory`` (key -> tensor memory), ``CDict`` (the memory plus existence
flags), ``CList`` (a circular-buffer deque) and ``CBag`` (a multiset of
integers with random pop), each a few contiguous tensors with masked
updates, and ``do_where``, a structure-wide ``torch.where``.

Batching comes in the JAX package's two interchangeable forms:

- **explicit batch shapes**: ``create(..., batch_shape=(B,))`` allocates a
  contiguous batch of structures; keys, values and ``where`` masks carry the
  batch shape on the left and every element addresses its own block;
- **``torch.func.vmap``**: a structure is a pytree dataclass
  (``tools/pytree.py``), so ``vmap`` over a stacked unbatched structure
  gives the same semantics.

As in the JAX package the API is functional: a method with a trailing
underscore (``set_``, ``add_``, ``append_``, ...) returns the updated
structure and leaves its input unchanged, and every update writes a fresh
tensor (``index_put``, ``torch.where``), which is what ``vmap`` needs.
Invalid keys are masked: ignored on write, ``default``-filled on read.
``CBag`` keeps per-key counts; ``pop_`` given a ``torch.Generator`` draws a
present key with probability proportional to its count (sampling without
replacement) from one uniform per bag.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import torch
import torch.utils._pytree as _pytree

from .._device import resolve_device
from .pytree import pytree_dataclass, replace, static_field

__all__ = ["do_where", "CMemory", "CDict", "CList", "CBag"]


def do_where(mask, a: Any, b: Any) -> Any:
    """Structure-wide ``where``: ``a`` where ``mask`` is True, else ``b``,
    leaf by leaf, the mask broadcast from the left."""
    mask = torch.as_tensor(mask)

    def pick(x, y):
        x, y = torch.as_tensor(x), torch.as_tensor(y)
        m = mask.reshape(mask.shape + (1,) * (x.ndim - mask.ndim))
        return torch.where(m, x, y)

    return _pytree.tree_map(pick, a, b)


def _open_grid(batch_shape: tuple, device) -> tuple:
    """Index tensors that broadcast to ``batch_shape`` (every batch element
    then addresses its own block in one gather or scatter)."""
    nb = len(batch_shape)
    out = []
    for i, d in enumerate(batch_shape):
        shape = [1] * nb
        shape[i] = d
        out.append(torch.arange(d, device=device).reshape(shape))
    return tuple(out)


def _as_tuple(x, n: int, what: str) -> tuple:
    if isinstance(x, (tuple, list)):
        if len(x) != n:
            raise ValueError(f"{what} must have {n} element(s), got {x!r}")
        return tuple(int(v) for v in x)
    return (int(x),) * n


def _broadcast_shapes(*shapes) -> tuple:
    return tuple(torch.broadcast_shapes(*shapes))


def _value(value, like: torch.Tensor, shape) -> torch.Tensor:
    return torch.as_tensor(value, dtype=like.dtype, device=like.device).broadcast_to(shape)


@pytree_dataclass
class CMemory:
    """Batched key -> tensor memory with masked updates.

    Keys are integers in ``[key_offset, key_offset + num_keys)``, or, with a
    tuple-valued ``num_keys``, tuples of integers addressing a multi-dim key
    space. With a ``batch_shape`` the object is a contiguous batch of
    memories: keys, values and ``where`` masks carry the batch shape on the
    left and each batch element reads and writes its own block.
    """

    data: torch.Tensor  # (*batch_shape, *key_shape, *value_shape)
    batch_ndim: int = static_field(default=0)
    key_ndim: int = static_field(default=1)
    key_offset: Optional[tuple] = static_field(default=None)

    @staticmethod
    def create(
        num_keys,
        *value_shape: int,
        dtype=torch.float32,
        fill: float = 0.0,
        batch_shape: tuple = (),
        key_offset=None,
        device=None,
    ) -> "CMemory":
        if isinstance(num_keys, (tuple, list)):
            key_shape = tuple(int(n) for n in num_keys)
        else:
            key_shape = (int(num_keys),)
        batch_shape = tuple(int(b) for b in batch_shape)
        offset = None if key_offset is None else _as_tuple(key_offset, len(key_shape), "key_offset")
        shape = batch_shape + key_shape + tuple(int(s) for s in value_shape)
        return CMemory(
            data=torch.full(shape, fill, dtype=dtype, device=resolve_device(device)),
            batch_ndim=len(batch_shape),
            key_ndim=len(key_shape),
            key_offset=offset,
        )

    # ------------------------------------------------------------ properties
    @property
    def batch_shape(self) -> tuple:
        return tuple(self.data.shape[: self.batch_ndim])

    @property
    def is_batched(self) -> bool:
        return self.batch_ndim > 0

    @property
    def key_shape(self) -> tuple:
        return tuple(self.data.shape[self.batch_ndim : self.batch_ndim + self.key_ndim])

    @property
    def num_keys(self):
        ks = self.key_shape
        return ks[0] if self.key_ndim == 1 else ks

    @property
    def value_shape(self) -> tuple:
        return tuple(self.data.shape[self.batch_ndim + self.key_ndim :])

    @property
    def value_ndim(self) -> int:
        return len(self.value_shape)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    # ------------------------------------------------------------ addressing
    def _normalize_keys(self, key) -> Tuple[tuple, torch.Tensor]:
        """-> (per-dim key tensors broadcast against the batch shape, the
        validity mask). Keys may carry extra leading dims: an unbatched
        memory indexed with a tensor of keys gathers, and a batched one
        accepts ``(K, *batch_shape)`` key stacks."""
        kd = self.key_ndim
        dev = self.data.device
        if kd > 1:
            if isinstance(key, (tuple, list)):
                parts = [torch.as_tensor(k, device=dev) for k in key]
                if len(parts) != kd:
                    raise ValueError(f"Expected {kd} key components, got {len(parts)}")
            else:
                arr = torch.as_tensor(key, device=dev)  # trailing dim = key dims
                parts = [arr[..., i] for i in range(kd)]
        else:
            parts = [torch.as_tensor(key, device=dev)]
        if self.key_offset is not None:
            parts = [p - o for p, o in zip(parts, self.key_offset)]
        common = _broadcast_shapes(self.batch_shape, *(p.shape for p in parts))
        parts = [p.broadcast_to(common) for p in parts]
        valid = torch.ones(common, dtype=torch.bool, device=dev)
        for p, d in zip(parts, self.key_shape):
            valid = valid & (p >= 0) & (p < d)
        return tuple(parts), valid

    def _address(self, parts: tuple) -> tuple:
        clipped = tuple(torch.clamp(p, 0, d - 1) for p, d in zip(parts, self.key_shape))
        return _open_grid(self.batch_shape, self.data.device) + clipped

    # ------------------------------------------------------------ read/write
    def get(self, key, default=None) -> torch.Tensor:
        parts, valid = self._normalize_keys(key)
        value = self.data[self._address(parts)]
        if default is not None:
            value = do_where(valid, value, _value(default, self.data, value.shape))
        return value

    def __getitem__(self, key) -> torch.Tensor:
        return self.get(key)

    def _apply(self, key, op, value, where) -> "CMemory":
        # keys with extra leading dims and DUPLICATES apply last-write-wins
        # (one read-modify-write per slot), as the JAX package's scatter
        parts, valid = self._normalize_keys(key)
        idx = self._address(parts)
        current = self.data[idx]
        new = op(current, _value(value, self.data, current.shape))
        mask = valid
        if where is not None:
            mask = mask & torch.as_tensor(where, device=self.data.device).broadcast_to(valid.shape)
        new = do_where(mask, new, current)
        return replace(self, data=self.data.index_put(idx, new))

    def set_(self, key, value, where=None) -> "CMemory":
        """Masked overwrite."""
        return self._apply(key, lambda cur, v: v, value, where)

    def add_(self, key, value, where=None) -> "CMemory":
        return self._apply(key, lambda cur, v: cur + v, value, where)

    def subtract_(self, key, value, where=None) -> "CMemory":
        return self._apply(key, lambda cur, v: cur - v, value, where)

    def multiply_(self, key, value, where=None) -> "CMemory":
        return self._apply(key, lambda cur, v: cur * v, value, where)

    def divide_(self, key, value, where=None) -> "CMemory":
        return self._apply(key, lambda cur, v: cur / v, value, where)

    def add_circular_(self, key, value, mod, where=None) -> "CMemory":
        """``slot = (slot + value) % mod``, masked."""
        mod = torch.as_tensor(mod, dtype=self.data.dtype, device=self.data.device)
        return self._apply(key, lambda cur, v: torch.remainder(cur + v, mod), value, where)


@pytree_dataclass
class CDict:
    """Batchable dictionary: a :class:`CMemory` plus per-key existence flags.

    Integer keys (``CDict.create(num_keys, *value_shape)``, or tuples with a
    tuple-valued ``num_keys``) or named keys (``CDict.create(["alpha",
    "beta"], *value_shape)``, a static namespace resolved to slots on the
    host). ``set_`` flags existence; the arithmetic updates change values
    but not existence; ``get`` with a ``default`` returns it for missing
    keys; ``clear`` resets the flags (not the values), optionally masked.
    """

    memory: CMemory
    exist: torch.Tensor  # (*batch_shape, *key_shape) bool
    names: Optional[tuple] = static_field(default=None)

    @staticmethod
    def create(
        keys_or_num_keys=None,
        *value_shape: int,
        dtype=torch.float32,
        fill: float = 0.0,
        batch_shape: tuple = (),
        key_offset=None,
        names=None,
        num_keys=None,
        device=None,
    ) -> "CDict":
        """Positional dispatch: an int (or tuple of ints) is a key-space
        shape; any other iterable is a name list. Pass ``names=[...]`` or
        ``num_keys=...`` to say which a sequence of integers is."""
        if names is not None or num_keys is not None:
            if keys_or_num_keys is not None:
                raise TypeError(
                    "Pass either the positional keys_or_num_keys or the explicit names=/num_keys= keywords, not both"
                )
            if names is not None and num_keys is not None:
                raise TypeError("names= and num_keys= are mutually exclusive")
            if names is not None:
                names = tuple(names)
                num_keys = len(names)
        elif keys_or_num_keys is None:
            raise TypeError("CDict.create needs keys_or_num_keys, names= or num_keys=")
        else:
            num_keys = keys_or_num_keys
            if not isinstance(keys_or_num_keys, int) and not (
                isinstance(keys_or_num_keys, (tuple, list)) and all(isinstance(k, int) for k in keys_or_num_keys)
            ):
                names = tuple(keys_or_num_keys)
                num_keys = len(names)
        memory = CMemory.create(
            num_keys, *value_shape, dtype=dtype, fill=fill, batch_shape=batch_shape, key_offset=key_offset, device=device
        )
        exist = torch.zeros(memory.batch_shape + memory.key_shape, dtype=torch.bool, device=memory.device)
        return CDict(memory=memory, exist=exist, names=names)

    def _key(self, key):
        if self.names is None:
            return key
        try:
            return self.names.index(key)
        except ValueError:
            raise KeyError(f"Unknown key: {key!r} (known: {self.names})") from None

    # ------------------------------------------------------------ properties
    @property
    def batch_shape(self) -> tuple:
        return self.memory.batch_shape

    @property
    def is_batched(self) -> bool:
        return self.memory.is_batched

    @property
    def value_shape(self) -> tuple:
        return self.memory.value_shape

    @property
    def dtype(self):
        return self.memory.dtype

    @property
    def data(self) -> torch.Tensor:
        return self.memory.data

    # ------------------------------------------------------------ read/write
    def contains(self, key) -> torch.Tensor:
        """Existence flag(s) of the given key(s)."""
        key = self._key(key)
        parts, valid = self.memory._normalize_keys(key)
        return self.exist[self.memory._address(parts)] & valid

    def get(self, key, default=None) -> torch.Tensor:
        """Value(s) at ``key``; with a ``default``, missing or invalid keys
        give the default instead of the stored filler."""
        key = self._key(key)
        if default is None:
            return self.memory.get(key)
        parts, valid = self.memory._normalize_keys(key)
        idx = self.memory._address(parts)
        present = valid & self.exist[idx]
        value = self.memory.data[idx]
        return do_where(present, value, _value(default, value, value.shape))

    def __getitem__(self, key) -> torch.Tensor:
        return self.get(key)

    def set_(self, key, value, where=None) -> "CDict":
        """Masked overwrite; flags the key as existing."""
        key = self._key(key)
        parts, valid = self.memory._normalize_keys(key)
        mask = valid
        if where is not None:
            mask = mask & torch.as_tensor(where, device=self.exist.device).broadcast_to(self.batch_shape)
        idx = self.memory._address(parts)
        new_exist = self.exist.index_put(idx, self.exist[idx] | mask)
        return CDict(memory=self.memory.set_(key, value, where), exist=new_exist, names=self.names)

    def _arith(self, method, key, value, where) -> "CDict":
        key = self._key(key)
        return replace(self, memory=getattr(self.memory, method)(key, value, where))

    def add_(self, key, value, where=None) -> "CDict":
        """Adds onto stored values; existence flags are NOT changed."""
        return self._arith("add_", key, value, where)

    def subtract_(self, key, value, where=None) -> "CDict":
        return self._arith("subtract_", key, value, where)

    def multiply_(self, key, value, where=None) -> "CDict":
        return self._arith("multiply_", key, value, where)

    def divide_(self, key, value, where=None) -> "CDict":
        return self._arith("divide_", key, value, where)

    def clear(self, where=None) -> "CDict":
        """Flag every key non-existent (values are kept); masked per batch
        element by ``where``."""
        if where is None:
            return replace(self, exist=torch.zeros_like(self.exist))
        where = torch.as_tensor(where, device=self.exist.device).broadcast_to(self.batch_shape)
        m = where.reshape(where.shape + (1,) * self.memory.key_ndim)
        return replace(self, exist=torch.where(m, False, self.exist))


@pytree_dataclass
class CList:
    """Fixed-capacity circular-buffer list (deque) with masked push and pop;
    with a batch shape every element carries its own begin/length cursor."""

    data: torch.Tensor  # (*batch_shape, capacity, *value_shape)
    begin: torch.Tensor  # (*batch_shape) int32
    length: torch.Tensor  # (*batch_shape) int32
    batch_ndim: int = static_field(default=0)

    @staticmethod
    def create(
        capacity: int,
        *value_shape: int,
        dtype=torch.float32,
        batch_shape: tuple = (),
        device=None,
    ) -> "CList":
        device = resolve_device(device)
        batch_shape = tuple(int(b) for b in batch_shape)
        return CList(
            data=torch.zeros(batch_shape + (int(capacity),) + tuple(int(s) for s in value_shape), dtype=dtype, device=device),
            begin=torch.zeros(batch_shape, dtype=torch.int32, device=device),
            length=torch.zeros(batch_shape, dtype=torch.int32, device=device),
            batch_ndim=len(batch_shape),
        )

    # ------------------------------------------------------------ properties
    @property
    def batch_shape(self) -> tuple:
        return tuple(self.data.shape[: self.batch_ndim])

    @property
    def is_batched(self) -> bool:
        return self.batch_ndim > 0

    @property
    def capacity(self) -> int:
        return self.data.shape[self.batch_ndim]

    @property
    def max_length(self) -> int:
        return self.capacity

    @property
    def value_shape(self) -> tuple:
        return tuple(self.data.shape[self.batch_ndim + 1 :])

    @property
    def dtype(self):
        return self.data.dtype

    def __len__(self):
        raise TypeError("Use .length (a tensor) instead of len() on a CList")

    @property
    def is_empty(self) -> torch.Tensor:
        return self.length == 0

    @property
    def is_full(self) -> torch.Tensor:
        return self.length == self.capacity

    # ------------------------------------------------------------ addressing
    def _phys(self, i) -> torch.Tensor:
        return torch.remainder(self.begin + i, self.capacity)

    def _index(self, phys) -> tuple:
        return _open_grid(self.batch_shape, self.data.device) + (phys,)

    def _logical(self, i) -> Tuple[torch.Tensor, torch.Tensor]:
        """Logical index (negative counts from the end, per element) ->
        physical position and validity. Extra leading dims on ``i`` gather
        several elements per list."""
        i = torch.as_tensor(i, device=self.data.device)
        common = _broadcast_shapes(self.batch_shape, i.shape)
        i = i.broadcast_to(common)
        i = torch.where(i < 0, i + self.length, i)
        valid = (i >= 0) & (i < self.length)
        return self._phys(torch.clamp(i, 0, self.capacity - 1)), valid

    # ------------------------------------------------------------ read/write
    def get(self, i, default=None) -> torch.Tensor:
        phys, valid = self._logical(i)
        value = self.data[self._index(phys)]
        if default is not None:
            value = do_where(valid, value, _value(default, self.data, value.shape))
        return value

    def __getitem__(self, i) -> torch.Tensor:
        return self.get(i)

    def _apply(self, i, op, value, where) -> "CList":
        phys, valid = self._logical(i)
        idx = self._index(phys)
        current = self.data[idx]
        mask = valid
        if where is not None:
            mask = mask & torch.as_tensor(where, device=self.data.device).broadcast_to(valid.shape)
        new = do_where(mask, op(current, _value(value, self.data, current.shape)), current)
        return replace(self, data=self.data.index_put(idx, new))

    def set_(self, i, value, where=None) -> "CList":
        return self._apply(i, lambda cur, v: v, value, where)

    def add_(self, i, value, where=None) -> "CList":
        return self._apply(i, lambda cur, v: cur + v, value, where)

    def subtract_(self, i, value, where=None) -> "CList":
        return self._apply(i, lambda cur, v: cur - v, value, where)

    def multiply_(self, i, value, where=None) -> "CList":
        return self._apply(i, lambda cur, v: cur * v, value, where)

    def divide_(self, i, value, where=None) -> "CList":
        return self._apply(i, lambda cur, v: cur / v, value, where)

    # ------------------------------------------------------------ push/pop
    def _can(self, other, where):
        can = other
        if where is not None:
            can = can & torch.as_tensor(where, device=self.data.device).broadcast_to(self.batch_shape)
        return can

    def append_(self, value, where=None) -> "CList":
        """Push to the end unless full (masked)."""
        can = self._can(~self.is_full, where)
        idx = self._index(self._phys(torch.remainder(self.length, self.capacity)))
        current = self.data[idx]
        new = do_where(can, _value(value, self.data, current.shape), current)
        return replace(self, data=self.data.index_put(idx, new), length=self.length + can.to(torch.int32))

    push_ = append_

    def appendleft_(self, value, where=None) -> "CList":
        can = self._can(~self.is_full, where)
        new_begin = torch.where(can, torch.remainder(self.begin - 1, self.capacity), self.begin)
        idx = self._index(new_begin)
        current = self.data[idx]
        new = do_where(can, _value(value, self.data, current.shape), current)
        return replace(
            self,
            data=self.data.index_put(idx, new),
            begin=new_begin,
            length=self.length + can.to(torch.int32),
        )

    def pop_(self, where=None) -> tuple:
        """Pop from the end (masked): ``(new_list, value)``, the value stale
        where the pop was masked out."""
        can = self._can(~self.is_empty, where)
        phys = self._phys(torch.clamp(self.length - 1, min=0))
        value = self.data[self._index(phys)]
        return replace(self, length=self.length - can.to(torch.int32)), value

    def popleft_(self, where=None) -> tuple:
        can = self._can(~self.is_empty, where)
        value = self.data[self._index(self.begin)]
        new_begin = torch.where(can, torch.remainder(self.begin + 1, self.capacity), self.begin)
        return replace(self, begin=new_begin, length=self.length - can.to(torch.int32)), value

    def clear(self, where=None) -> "CList":
        """Empty the list(s); masked per batch element by ``where``."""
        if where is None:
            return replace(self, length=torch.zeros_like(self.length))
        where = torch.as_tensor(where, device=self.length.device).broadcast_to(self.batch_shape)
        return replace(self, length=torch.where(where, 0, self.length))


@pytree_dataclass
class CBag:
    """A bag (multiset) of integers in ``[0, num_keys)`` with random pop
    (sampling without replacement), kept as per-key counts. ``capacity``
    optionally bounds the number of elements; pushes into a full bag are
    masked no-ops."""

    counts: torch.Tensor  # (*batch_shape, num_keys) int32
    batch_ndim: int = static_field(default=0)
    capacity: Optional[int] = static_field(default=None)

    @staticmethod
    def create(num_keys: int, *, batch_shape: tuple = (), capacity: Optional[int] = None, device=None) -> "CBag":
        batch_shape = tuple(int(b) for b in batch_shape)
        return CBag(
            counts=torch.zeros(batch_shape + (int(num_keys),), dtype=torch.int32, device=resolve_device(device)),
            batch_ndim=len(batch_shape),
            capacity=None if capacity is None else int(capacity),
        )

    # ------------------------------------------------------------ properties
    @property
    def batch_shape(self) -> tuple:
        return tuple(self.counts.shape[: self.batch_ndim])

    @property
    def is_batched(self) -> bool:
        return self.batch_ndim > 0

    @property
    def num_keys(self) -> int:
        return self.counts.shape[-1]

    @property
    def total(self) -> torch.Tensor:
        return self.counts.sum(dim=-1, dtype=torch.int32)

    @property
    def length(self) -> torch.Tensor:
        return self.total

    @property
    def max_length(self) -> Optional[int]:
        return self.capacity

    # ------------------------------------------------------------ operations
    def _keys(self, key) -> torch.Tensor:
        key = torch.as_tensor(key, device=self.counts.device)
        return key.broadcast_to(_broadcast_shapes(self.batch_shape, key.shape))

    def _where(self, where, shape) -> torch.Tensor:
        return torch.as_tensor(where, device=self.counts.device).broadcast_to(shape)

    def push_(self, key, where=None) -> "CBag":
        """Push key(s); extra leading dims beyond the batch shape push
        several in one call (duplicates accumulate). With a ``capacity``,
        admission is checked against the total before the call."""
        key = self._keys(key)
        ok = (key >= 0) & (key < self.num_keys)
        if self.capacity is not None:
            ok = ok & (self.total < self.capacity)
        if where is not None:
            ok = ok & self._where(where, key.shape)
        idx = _open_grid(self.batch_shape, self.counts.device) + (torch.clamp(key, 0, self.num_keys - 1),)
        ok = ok.broadcast_to(key.shape)
        return replace(self, counts=self.counts.index_put(idx, ok.to(torch.int32), accumulate=True))

    def clear(self, where=None) -> "CBag":
        if where is None:
            return replace(self, counts=torch.zeros_like(self.counts))
        where = self._where(where, self.batch_shape)
        return replace(self, counts=torch.where(where[..., None], 0, self.counts))

    def _pop_specific(self, key, where) -> tuple:
        # presence is checked against the counts before the call; the clamp
        # keeps the counts >= 0 when one call pops a key more than it holds
        key = self._keys(key)
        idx = _open_grid(self.batch_shape, self.counts.device) + (torch.clamp(key, 0, self.num_keys - 1),)
        ok = (key >= 0) & (key < self.num_keys) & (self.counts[idx] > 0)
        if where is not None:
            ok = ok & self._where(where, key.shape)
        counts = torch.clamp(self.counts.index_put(idx, -ok.to(torch.int32), accumulate=True), min=0)
        return replace(self, counts=counts), key, ok

    def _pop_random(self, generator: torch.Generator, where) -> tuple:
        bs = self.batch_shape
        u = torch.rand(bs, generator=generator, dtype=torch.float64, device=generator.device).to(self.counts.device)
        total = self.total.to(torch.int64)
        # the key whose count interval holds floor(u * total); an empty bag
        # picks uniformly (the pop is then not ok)
        target = torch.clamp((u * total).floor().to(torch.int64), max=torch.clamp(total - 1, min=0))
        cumulative = torch.cumsum(self.counts.to(torch.int64), dim=-1)
        in_bag = torch.searchsorted(cumulative, target[..., None], right=True)[..., 0]
        uniform = torch.clamp((u * self.num_keys).floor().to(torch.int64), max=self.num_keys - 1)
        picked = torch.where(total > 0, in_bag, uniform)
        idx = _open_grid(bs, self.counts.device) + (picked,)
        ok = self.counts[idx] > 0
        if where is not None:
            ok = ok & self._where(where, bs)
        new = replace(self, counts=self.counts.index_put(idx, -ok.to(torch.int32), accumulate=True))
        return new, picked, ok

    def pop_(self, key_or_generator, where=None) -> tuple:
        """Pop a specific key (integer(s)) or, given a ``torch.Generator``,
        a random present key. Returns ``(new_bag, popped_key, ok)``, each
        batch-shaped."""
        if isinstance(key_or_generator, torch.Generator):
            return self._pop_random(key_or_generator, where)
        return self._pop_specific(key_or_generator, where)
