"""Factored population representations (counterpart of
``evotorch_tpu/tools/lowrank.py``).

A factored population is ``theta_i = center + basis @ coeffs[i]``: a shared
per-generation basis ``(L, k)`` with any per-parameter scale (PGPE's sigma)
folded in, and per-lane coefficients ``(N, k)``, so the dense ``(N, L)``
matrix is never built. Two forms speak that algebra:

- ``LowRankParamsBatch``: an unstructured basis (the policy forward runs one
  augmented product per layer, ``neuroevolution/net/lowrank.py``);
- ``TrunkDeltaParamsBatch``: every basis column is rank 1 over each 2-D
  weight block, ``vec(b_m a_m^T)``; ``factors`` holds the ``(a, b)`` pair of
  every parameter leaf in the flat layout's order and the policy forward
  runs one shared trunk product plus two thin ones per layer. ``basis`` is
  the same population materialized from the factors, which the gradients,
  the guardrail and concatenation read.

Per-lane state lives only in ``coeffs`` for both forms (``is_factored``),
so ``take`` gathers coefficient rows and leaves the shared tensors as they
are. Both are ``NamedTuple``s of tensors; treat them as immutable.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

__all__ = [
    "FACTORED_BATCH_TYPES",
    "LowRankParamsBatch",
    "TrunkDeltaParamsBatch",
    "basis_capture",
    "dense_values",
    "is_factored",
]


def _row_block(rows: torch.Tensor, start: int, stop: int, size: int) -> torch.Tensor:
    """``rows[start:stop]`` padded to ``size`` rows with copies of row 0
    (always a valid solution; the padding is masked wherever it is used)."""
    block = rows[start:stop]
    if block.shape[0] == size:
        return block
    return torch.cat([block, rows[:1].expand(size - block.shape[0], *rows.shape[1:])])


class LowRankParamsBatch(NamedTuple):
    """A population expressed as ``theta_i = center + basis @ coeffs[i]``;
    ``basis`` is the effective basis, sigma folded in."""

    center: torch.Tensor  # (L,)
    basis: torch.Tensor  # (L, k)
    coeffs: torch.Tensor  # (N, k)

    @property
    def popsize(self) -> int:
        return int(self.coeffs.shape[0])

    @property
    def rank(self) -> int:
        return int(self.basis.shape[-1])

    def block(self, start: int, stop: int, size: int) -> "LowRankParamsBatch":
        """Rows ``[start, stop)`` padded to ``size`` rows with copies of row
        0 (a rank's block of a sharded population); the shared tensors are
        shared."""
        return self._replace(coeffs=_row_block(self.coeffs, start, stop, size))

    def take(self, idx) -> "LowRankParamsBatch":
        """The lanes ``idx`` (coefficient rows); center and basis are shared."""
        return self._replace(coeffs=self.coeffs[idx])

    def materialize(self) -> torch.Tensor:
        """The dense ``(N, L)`` population: the matrix this form exists not
        to build."""
        return self.materialize_rows(self.coeffs)

    def materialize_rows(self, coeff_rows: torch.Tensor) -> torch.Tensor:
        """Coefficient rows ``(K, k)`` densified into parameter rows
        ``(K, L)``."""
        return self.center + coeff_rows @ self.basis.T


class TrunkDeltaParamsBatch(NamedTuple):
    """A population ``theta_i = center + basis @ coeffs[i]`` whose basis is
    structured: ``factors[j]`` is the ``(a, b)`` pair of leaf ``j`` of the
    flat layout (``net/lowrank.py``'s ``_Factor``), and ``basis`` is its
    materialization. Build one through the samplers, not by hand."""

    center: torch.Tensor  # (L,)
    basis: torch.Tensor  # (L, k), materialized from the factors
    coeffs: torch.Tensor  # (N, k)
    factors: Any  # one _Factor(a, b) per parameter leaf, in layout order

    @property
    def popsize(self) -> int:
        return int(self.coeffs.shape[0])

    @property
    def rank(self) -> int:
        return int(self.basis.shape[-1])

    def block(self, start: int, stop: int, size: int) -> "TrunkDeltaParamsBatch":
        """Rows ``[start, stop)`` padded to ``size`` rows with copies of row
        0 (a rank's block of a sharded population); the shared tensors are
        shared."""
        return self._replace(coeffs=_row_block(self.coeffs, start, stop, size))

    def take(self, idx) -> "TrunkDeltaParamsBatch":
        """The lanes ``idx``; center, basis and factors are shared."""
        return self._replace(coeffs=self.coeffs[idx])

    def materialize(self) -> torch.Tensor:
        """The dense ``(N, L)`` population."""
        return self.materialize_rows(self.coeffs)

    def materialize_rows(self, coeff_rows: torch.Tensor) -> torch.Tensor:
        """Coefficient rows ``(K, k)`` densified into ``(K, L)``."""
        return self.center + coeff_rows @ self.basis.T


#: every factored form: per-lane state lives only in ``coeffs``
FACTORED_BATCH_TYPES = (LowRankParamsBatch, TrunkDeltaParamsBatch)


def is_factored(values) -> bool:
    """True for a low-rank or trunk-delta population."""
    return isinstance(values, FACTORED_BATCH_TYPES)


def basis_capture(basis: torch.Tensor, vector: torch.Tensor) -> torch.Tensor:
    """The share of ``vector``'s norm inside ``span(basis)``, ``||P_B v|| /
    ||v||`` in ``[0, 1]`` (1.0 for a zero vector), as a device scalar.

    A random rank-``k`` basis in ``L`` dimensions captures about
    ``sqrt(k/L)`` of a fixed direction; a capture that stays far below 1
    means most of the gradient the dense estimator would follow cannot be
    expressed in the generation's subspace. One ridge-regularized ``k x k``
    solve (``solve_ex``: no host sync for an error check)."""
    v_sq = torch.sum(vector * vector)
    gram = basis.T @ basis
    proj = basis.T @ vector
    eye = torch.eye(gram.shape[0], dtype=gram.dtype, device=gram.device)
    ridge = 1e-12 * torch.clamp(torch.trace(gram), min=1e-30)
    coef, _ = torch.linalg.solve_ex(gram + ridge * eye, proj)
    captured_sq = torch.clamp(proj @ coef, min=0.0)
    frac = torch.sqrt(captured_sq / torch.clamp(v_sq, min=1e-30))
    return torch.where(v_sq > 0, torch.clamp(frac, 0.0, 1.0), torch.ones((), dtype=frac.dtype, device=frac.device))


def dense_values(values):
    """A factored population materialized into its ``(N, L)`` matrix;
    anything else as it is. Evaluators that only take dense vectors (plain
    fitness functions, per-network evaluations) call this at their entry."""
    if is_factored(values):
        return values.materialize()
    return values
