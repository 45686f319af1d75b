"""Operators for variable-length (object-typed) solutions (counterpart of
``evotorch_tpu/operators/sequence.py``): ``CutAndSplice``, one-point
crossover of sequences of differing lengths, on the host."""

from __future__ import annotations

from typing import List, Sequence

import torch

from ..core import SolutionBatch
from ..tools.objectarray import ObjectArray
from .base import CrossOver

__all__ = ["CutAndSplice"]


def _draw_splice_cuts(generator: torch.Generator, lengths1: Sequence[int], lengths2: Sequence[int]):
    """A cut point for each parent, uniform in ``[0, len]``: two lists of
    host integers from one draw."""
    lengths = torch.tensor([list(lengths1), list(lengths2)], dtype=torch.float64)
    u = torch.rand(lengths.shape, generator=generator, dtype=torch.float64, device=generator.device).cpu()
    cuts = torch.minimum(torch.floor(u * (lengths + 1)), lengths).to(torch.int64)
    return cuts[0].tolist(), cuts[1].tolist()


def _cut_and_splice_core(parents1, parents2, cuts1: List[int], cuts2: List[int]) -> ObjectArray:
    """Children ``a[:i] + b[j:]`` then ``b[:j] + a[i:]`` of each pair: the
    first children of all pairs, then the second ones."""
    n = len(parents1)
    children = ObjectArray(2 * n)
    for i in range(n):
        a, b = list(parents1[i]), list(parents2[i])
        children[i] = a[: cuts1[i]] + b[cuts2[i] :]
        children[n + i] = b[: cuts2[i]] + a[cuts1[i] :]
    return children


class CutAndSplice(CrossOver):
    """Cut-and-splice crossover of object-typed (sequence) solutions: each
    pair of parents is cut at a random point of each and the pieces
    swapped, so the children's lengths may differ from the parents'."""

    def _do_cross_over(self, parents1, parents2) -> SolutionBatch:
        cuts1, cuts2 = _draw_splice_cuts(self._problem.generator, [len(p) for p in parents1], [len(p) for p in parents2])
        children = _cut_and_splice_core(parents1, parents2, cuts1, cuts2)
        return SolutionBatch(self._problem, len(children), values=children)
