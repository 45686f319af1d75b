"""The yardstick of a factored (low-rank) policy forward: the operations and
bytes of the port's low-rank path for a tanh MLP of layer sizes ``sizes``
(``[obs, hidden..., act]``, the plain policy's ``sizes``) at rank ``k``.

A low-rank population ``theta_i = c + B z_i`` runs each layer as one
shared-weight product ``x @ [W_c; D_1; ...; D_k]^T`` of ``(k+1) * out``
columns, then the per-lane combination ``y_c + sum_m z_im y_m``. The
product's multiply-adds are ``in * (k+1) * out`` a lane, the combination's
``(k+1) * out`` (the center's column block counted as one). Bytes: the
augmented weights and bias, read once for all lanes; per lane ``x`` read,
the product's ``y_aug`` written and read again by the combination (the two
stages of the path), the coefficients read and ``y`` written, each layer.
Float32 throughout.
"""

from __future__ import annotations

from typing import Optional, Sequence

__all__ = ["lowrank_forward_bytes", "lowrank_forward_flops", "policy_flops_per_step"]

_F32 = 4


def _layers(sizes: Sequence[int]):
    sizes = [int(s) for s in sizes]
    return list(zip(sizes[:-1], sizes[1:]))


def lowrank_forward_flops(sizes: Sequence[int], k: int, lanes: int) -> int:
    """Operations (two a multiply-add) of one low-rank forward of
    ``lanes`` lanes: ``2 * lanes * sum in * (k+1) * out`` for the products
    and ``2 * lanes * (k+1) * out`` a layer for the combination."""
    k, lanes = int(k), int(lanes)
    return sum(2 * lanes * (k + 1) * out * (fan_in + 1) for fan_in, out in _layers(sizes))


def lowrank_forward_bytes(sizes: Sequence[int], k: int, lanes: int) -> int:
    """Bytes of one low-rank forward of ``lanes`` lanes: each layer's
    augmented weight ``(k+1) * out * in`` and bias ``(k+1) * out`` read
    once; per lane ``x`` (``in``) read, ``y_aug`` (``(k+1) * out``) written
    and read, the coefficients (``k``) read and ``y`` (``out``) written."""
    k, lanes = int(k), int(lanes)
    total = 0
    for fan_in, out in _layers(sizes):
        shared = (k + 1) * out * (fan_in + 1)
        per_lane = fan_in + 2 * (k + 1) * out + k + out
        total += shared + lanes * per_lane
    return total * _F32


def policy_flops_per_step(policy, k: int) -> Optional[int]:
    """A lane's operations a control step on the low-rank path, for a plain
    policy with layer ``sizes`` (the tanh MLP); None for another policy,
    which this yardstick does not count."""
    sizes = getattr(policy, "sizes", None)
    return None if sizes is None else lowrank_forward_flops(sizes, k, 1)
