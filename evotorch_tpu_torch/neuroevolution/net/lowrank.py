"""Factored policy forwards: the whole population from a shared basis
(counterpart of ``evotorch_tpu/neuroevolution/net/lowrank.py``).

A dense population runs one batched product per layer in which every lane
reads its own weights: at 256x256 and popsize 10,000 that is 3.93 GB read
on every control step. A factored population ``theta_i = c + B z_i``
(``tools/lowrank.py``) turns each weight into ``W_c + sum_m z_im D_m`` with
shared ``D_m``, so a layer reads shared weights once for all lanes:

- **low-rank** (``LowRankParamsBatch``): one augmented product
  ``x @ [W_c; D_1; ...; D_k]^T`` of ``(k+1) * out`` columns, then the
  per-lane combination ``y_c + sum_m z_im y_m`` as one ``torch.baddbmm``;
- **trunk-delta** (``TrunkDeltaParamsBatch``): every ``D_m`` is rank 1,
  ``b_m a_m^T``, so a layer is ``x @ W_c^T + ((x @ A) * z) @ B^T``: one
  trunk product (``[W_c^T | A]``, ``out + k`` columns) and one thin one.

RNN and LSTM cells augment both of their products the same way. Modules
without a structured path fall back to the dense population, with a
warning (the JAX package's rule).

Conventions of the port:

- A parameter *leaf* is one entry of ``FlatParamsPolicy.layout``, in the
  flat layout's order (``bias`` before ``weight``; ``W_hh, W_ih, b_hh,
  b_ih``), which is the JAX package's ``ravel_pytree`` order; the factors of
  ``sample_trunk_delta_factors`` are a list in that order.
- The JAX basis tree puts ``k`` last (``(out, in, k)``); here the basis
  leaves are ``(k, *shape)``, views of ``basis.T`` through
  ``policy.unravel``.
- The loop-invariant work (each layer's augmented weight and bias) is done
  once per rollout in ``prepare_lowrank`` / ``prepare_trunk_delta``, not on
  every control step; the JAX package builds it inside the jitted step,
  where XLA hoists it. A center bias, and for low-rank the basis's bias
  directions, are folded into the augmented product's bias.
- Inputs are ``(B, in)``: one observation per lane.
"""

from __future__ import annotations

import warnings
from typing import Any, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...tools.lowrank import LowRankParamsBatch, TrunkDeltaParamsBatch
from .layers import LSTM, RNN, Bias, Linear, Module, Sequential, map_state

__all__ = [
    "LowRankParamsBatch",
    "TrunkDeltaParamsBatch",
    "lowrank_supported",
    "prepare_lowrank",
    "lowrank_forward",
    "trunk_delta_supported",
    "sample_trunk_delta_factors",
    "prepare_trunk_delta",
    "trunk_delta_forward",
]

_STRUCTURED = (Linear, Bias, RNN, LSTM)


def lowrank_supported(module: Module) -> bool:
    """True when the module has a structured factored forward: Sequential
    stacks of Linear / Bias / RNN / LSTM / parameterless layers."""
    if isinstance(module, Sequential):
        return all(lowrank_supported(m) for m in module.modules)
    if isinstance(module, _STRUCTURED):
        return True
    return _is_parameterless(module)


def _is_parameterless(module: Module) -> bool:
    return not module.param_shapes() and not module.is_stateful


def _fallback_warning(form: str, params, module: Module) -> None:
    warnings.warn(
        f"{form} forward fell back to materializing the dense ({params.popsize}, {params.center.shape[-1]})"
        f" population: {type(module).__name__} has no structured {form} path (supported: Sequential stacks"
        " of Linear/Bias/RNN/LSTM/parameterless layers)",
        stacklevel=3,
    )


def _split_leaves(module: Module, *leaf_lists):
    """Walk ``module`` as ``Sequential.apply`` does: yields ``(layer,
    leaves of each list)`` for every non-Sequential layer, in order."""
    at = 0

    def walk(m):
        nonlocal at
        if isinstance(m, Sequential):
            for sub in m.modules:
                yield from walk(sub)
            return
        count = len(m.param_shapes())
        yield m, [leaves[at : at + count] for leaves in leaf_lists]
        at += count

    yield from walk(module)


def _apply_layers(module: Module, layers: list, one, z, x, state):
    """Thread ``x`` and the per-module states through ``module`` as
    ``Sequential.apply`` does, applying ``one(layer, prepared, z, x, state)``
    to each structured layer and the plain ``apply`` to parameterless ones.
    ``layers`` holds one prepared entry per non-Sequential layer."""
    it = iter(layers)

    def run(m, x, state):
        if isinstance(m, Sequential):
            states = (None,) * len(m.modules) if state is None else state
            new_states = []
            for sub, s in zip(m.modules, states):
                x, s = run(sub, x, s)
                new_states.append(s)
            return x, (None if all(s is None for s in new_states) else tuple(new_states))
        prepared = next(it)
        if prepared is None:
            return m.apply([], x, state)
        return one(m, prepared, z, x, state)

    return run(module, x, state)


# ------------------------------------------------------------------ low-rank


class _Prepared(NamedTuple):
    """The loop-invariant context of a low-rank rollout: one entry per
    layer (None for a parameterless one; for a structured one its augmented
    weight, transposed, ``(in, (k+1) * out)`` and augmented bias) and the
    per-lane coefficients."""

    layers: list
    coeffs: torch.Tensor


def _augment(center_w: torch.Tensor, basis_w: torch.Tensor) -> torch.Tensor:
    """``[W_c; D_1; ...; D_k]^T``, ``(in, (k+1) * out)``, from ``W_c`` ``(out,
    in)`` and the basis leaf ``(k, out, in)``."""
    k, out_f, in_f = basis_w.shape
    return torch.cat([center_w, basis_w.reshape(k * out_f, in_f)], dim=0).T


def _augment_bias(center_b: torch.Tensor, basis_b: torch.Tensor) -> torch.Tensor:
    """``[b_c, b_1, ..., b_k]`` from ``b_c`` ``(out,)`` and the basis leaf
    ``(k, out)``: the per-lane bias ``b_c + sum_m z_m b_m`` then comes out of
    the same combination as the weights'."""
    return torch.cat([center_b, basis_b.reshape(-1)])


def _prepare_lowrank_layer(layer: Module, center: list, basis: list):
    if isinstance(layer, Linear):
        if layer.bias:
            (cb, cw), (bb, bw) = center, basis
            return {"w": _augment(cw, bw), "bias": _augment_bias(cb, bb), "out": layer.out_features}
        return {"w": _augment(center[0], basis[0]), "bias": None, "out": layer.out_features}
    if isinstance(layer, Bias):
        return {"bias_c": center[0], "bias_b": basis[0]}
    if isinstance(layer, (RNN, LSTM)):
        c_hh, c_ih, cb_hh, cb_ih = center
        b_hh, b_ih, bb_hh, bb_ih = basis
        return {
            "w_ih": _augment(c_ih, b_ih),
            "w_hh": _augment(c_hh, b_hh),
            "bias": _augment_bias(cb_ih + cb_hh, bb_ih + bb_hh),
            "out": c_ih.shape[0],
        }
    return None


def prepare_lowrank(policy, params: LowRankParamsBatch) -> _Prepared:
    """Build every layer's augmented weight and bias: call once per
    rollout, outside the stepping loop."""
    center = [leaf[0] for leaf in policy.unravel(params.center[None])]
    basis = policy.unravel(params.basis.T)  # (k, *shape) views
    layers = [_prepare_lowrank_layer(m, c, b) for m, (c, b) in _split_leaves(policy.module, center, basis)]
    return _Prepared(layers, params.coeffs)


def _lane_combine(y_aug: torch.Tensor, z: torch.Tensor, out: int) -> torch.Tensor:
    """``y_aug[:, :out] + sum_m z[:, m] * y_aug[:, (m+1)*out:(m+2)*out]``:
    one ``baddbmm`` over strided views."""
    corr = y_aug[:, out:].unflatten(1, (z.shape[1], out))
    return torch.baddbmm(y_aug[:, :out].unsqueeze(1), z.unsqueeze(1), corr).squeeze(1)


def _augmented_matmul(w_aug_t: torch.Tensor, bias_aug: Optional[torch.Tensor], z, x, out: int) -> torch.Tensor:
    """``x`` ``(B, in)`` times each lane's weight ``W_c + sum_m z_m D_m``
    (plus its bias), as one dense product against the augmented weight and
    the per-lane combination. Returns ``(B, out)``."""
    y_aug = torch.mm(x, w_aug_t) if bias_aug is None else torch.addmm(bias_aug, x, w_aug_t)
    return _lane_combine(y_aug, z, out)


def _lowrank_layer(layer: Module, p: dict, z, x, state):
    if isinstance(layer, Linear):
        return _augmented_matmul(p["w"], p["bias"], z, x, p["out"]), state
    if isinstance(layer, Bias):
        return x + torch.addmm(p["bias_c"], z, p["bias_b"]), state
    # RNN / LSTM: both products into one augmented pre-activation
    y_aug = torch.addmm(p["bias"], x, p["w_ih"])
    y_aug = torch.addmm(y_aug, layer._hidden(state, x), p["w_hh"])
    return layer._from_pre(_lane_combine(y_aug, z, p["out"]), state)


def _apply_lowrank(module: Module, layers: list, z, x, state):
    """The structured whole-population forward, threading per-lane states
    as ``Sequential.apply`` does. Returns ``(y, new_state)``."""
    return _apply_layers(module, layers, _lowrank_layer, z, x, state)


def lowrank_forward(policy, params: LowRankParamsBatch, prepared: Optional[_Prepared], obs, states) -> Tuple[torch.Tensor, Any]:
    """Whole-population forward ``obs`` ``(B, obs_dim)`` -> ``(B, act_dim)``
    and the new states. ``prepared`` may be None (built on the spot: outside
    hot loops only). An unstructured module falls back to the dense
    population, with a warning."""
    module = policy.module
    if lowrank_supported(module):
        if prepared is None:
            prepared = prepare_lowrank(policy, params)
        return _apply_lowrank(module, prepared.layers, prepared.coeffs, obs, states)
    _fallback_warning("low-rank", params, module)
    return policy(params.materialize(), obs, states)


# --------------------------------------------------------------- trunk-delta


class _Factor(NamedTuple):
    """The delta factors of one parameter leaf. A 2-D weight ``(out, in)``:
    ``a`` ``(in, k)`` and ``b`` ``(out, k)``, the block's scale folded into
    ``b``. A 1-D leaf: ``a`` an empty ``(0, k)`` and ``b`` its ``(size, k)``
    sigma-folded directions."""

    a: torch.Tensor
    b: torch.Tensor


def trunk_delta_supported(module: Module) -> bool:
    """The trunk-delta path covers the same stacks as the low-rank one."""
    return lowrank_supported(module)


def _draw_factor_noise(generator: torch.Generator, stream: int, shape: tuple, dtype: torch.dtype) -> torch.Tensor:
    """The standard-normal draw of one factor: ``stream`` is ``2 j`` for leaf
    ``j``'s ``a`` and ``2 j + 1`` for its ``b`` (the JAX sampler's
    ``fold_in`` index; the parity tests patch this draw)."""
    return torch.randn(tuple(shape), generator=generator, dtype=dtype, device=generator.device)


def sample_trunk_delta_factors(generator: torch.Generator, policy, sigma: torch.Tensor, rank: int):
    """One generation's delta factors and their materialized basis.

    Returns ``(factors, basis)``: one :class:`_Factor` per parameter leaf in
    layout order, and the flat ``(L, k)`` effective basis whose column ``m``
    is ``vec(b_m a_m^T)`` for each 2-D leaf and the direction column for each
    1-D one. A 1-D leaf folds its per-parameter sigma exactly; a 2-D leaf
    folds its block's RMS sigma (a per-parameter scale would break the rank-1
    structure), so a delta entry has variance ``sigma^2`` (blockwise)."""
    rank = int(rank)
    sigma_leaves = [leaf[0] for leaf in policy.unravel(sigma[None])]
    # 1 / sqrt(k) in float32, computed on the host as the JAX sampler's
    # float32 ops compute it (a Python float, exact in float32: no copy)
    inv_sqrt_k = float(np.float32(1.0) / np.sqrt(np.float32(rank)))
    factors, basis_leaves = [], []
    for j, s in enumerate(sigma_leaves):
        if s.ndim == 2:
            out_f, in_f = s.shape
            a = _draw_factor_noise(generator, 2 * j, (in_f, rank), s.dtype)
            block_rms = torch.sqrt(torch.mean(s * s))
            b = _draw_factor_noise(generator, 2 * j + 1, (out_f, rank), s.dtype) * (block_rms * inv_sqrt_k)
            factors.append(_Factor(a=a, b=b))
            basis_leaves.append((b[:, None, :] * a[None, :, :]).reshape(out_f * in_f, rank))
        elif s.ndim == 1:
            dirs = _draw_factor_noise(generator, 2 * j + 1, (s.shape[0], rank), s.dtype) * inv_sqrt_k * s[:, None]
            factors.append(_Factor(a=torch.zeros((0, rank), dtype=s.dtype, device=s.device), b=dirs))
            basis_leaves.append(dirs)
        else:
            raise ValueError(f"trunk-delta factors need 1-D or 2-D parameter leaves; got shape {tuple(s.shape)} (leaf {j})")
    return factors, torch.cat(basis_leaves, dim=0)


class _TrunkPrepared(NamedTuple):
    """The loop-invariant context of a trunk-delta rollout: one entry per
    layer (the trunk weight with the ``a`` factors beside it, ``(in, out +
    k)``, its bias, and the ``b`` factors), the per-lane coefficients and
    the lane-block size (0: one block)."""

    layers: list
    coeffs: torch.Tensor
    trunk_block: int = 0


def _trunk_weight(center_w: torch.Tensor, fac: _Factor) -> torch.Tensor:
    """``[W_c^T | a]``, ``(in, out + k)``: the trunk and the first thin
    product in one."""
    return torch.cat([center_w.T, fac.a], dim=1)


def _trunk_bias(center_b: torch.Tensor, k: int) -> torch.Tensor:
    return torch.cat([center_b, center_b.new_zeros(k)])


def _prepare_trunk_layer(layer: Module, center: list, factors: list):
    if isinstance(layer, Linear):
        if layer.bias:
            (cb, cw), (fb, fw) = center, factors
            k = fw.a.shape[1]
            return {"w": _trunk_weight(cw, fw), "bias": _trunk_bias(cb, k), "b_t": fw.b.T, "bias_b_t": fb.b.T, "out": cw.shape[0]}
        (cw,), (fw,) = center, factors
        return {"w": _trunk_weight(cw, fw), "bias": None, "b_t": fw.b.T, "bias_b_t": None, "out": cw.shape[0]}
    if isinstance(layer, Bias):
        return {"bias_c": center[0], "bias_b_t": factors[0].b.T}
    if isinstance(layer, (RNN, LSTM)):
        c_hh, c_ih, cb_hh, cb_ih = center
        f_hh, f_ih, fb_hh, fb_ih = factors
        k = f_ih.a.shape[1]
        return {
            "w_ih": _trunk_weight(c_ih, f_ih),
            "w_hh": _trunk_weight(c_hh, f_hh),
            "bias": _trunk_bias(cb_ih + cb_hh, k),
            "b_ih_t": f_ih.b.T,
            "b_hh_t": f_hh.b.T,
            "bias_b_t": (fb_ih.b + fb_hh.b).T,
            "out": c_ih.shape[0],
        }
    return None


def prepare_trunk_delta(policy, params: TrunkDeltaParamsBatch, *, trunk_block: int = 0) -> _TrunkPrepared:
    """Build every layer's trunk weight and bias: call once per rollout,
    outside the stepping loop."""
    center = [leaf[0] for leaf in policy.unravel(params.center[None])]
    layers = [
        _prepare_trunk_layer(m, c, f) for m, (c, f) in _split_leaves(policy.module, center, list(params.factors))
    ]
    return _TrunkPrepared(layers, params.coeffs, int(trunk_block))


def _trunk_matmul(w_cat: torch.Tensor, bias: Optional[torch.Tensor], b_t: torch.Tensor, z, x, out: int) -> torch.Tensor:
    """``x`` ``(B, in)`` times each lane's weight ``W_c + sum_m z_m b_m
    a_m^T`` (plus the center bias): the trunk product with ``x @ a`` beside
    it, then ``((x @ a) * z) @ b^T`` added. Returns ``(B, out)``."""
    y_t = torch.mm(x, w_cat) if bias is None else torch.addmm(bias, x, w_cat)
    return torch.addmm(y_t[:, :out], y_t[:, out:] * z, b_t)


def _trunk_layer(layer: Module, p: dict, z, x, state):
    if isinstance(layer, Linear):
        y = _trunk_matmul(p["w"], p["bias"], p["b_t"], z, x, p["out"])
        return (y if p["bias_b_t"] is None else torch.addmm(y, z, p["bias_b_t"])), state
    if isinstance(layer, Bias):
        return x + torch.addmm(p["bias_c"], z, p["bias_b_t"]), state
    out = p["out"]
    y_ih = torch.addmm(p["bias"], x, p["w_ih"])
    y_hh = torch.mm(layer._hidden(state, x), p["w_hh"])
    pre = torch.addmm(y_ih[:, :out] + y_hh[:, :out], y_ih[:, out:] * z, p["b_ih_t"])
    pre = torch.addmm(pre, y_hh[:, out:] * z, p["b_hh_t"])
    pre = torch.addmm(pre, z, p["bias_b_t"])
    return layer._from_pre(pre, state)


def _apply_trunk_delta(module: Module, layers: list, z, x, state):
    """The whole-population trunk-delta forward. Returns ``(y, new_state)``."""
    return _apply_layers(module, layers, _trunk_layer, z, x, state)


def _apply_trunk_delta_blocked(module: Module, layers: list, z, obs, states, block: int):
    """The same forward over blocks of ``block`` lanes, one after the other,
    bounding each product's working set. Lanes are independent, so blocking
    changes the schedule, not the function; the products' round-off may
    differ with their row count."""
    outs, new_states = [], []
    for lo in range(0, obs.shape[0], block):
        part = slice(lo, lo + block)
        y, s = _apply_trunk_delta(module, layers, z[part], obs[part], map_state(lambda t: t[part], states))
        outs.append(y)
        new_states.append(s)
    merged = None if new_states[0] is None else map_state(lambda *parts: torch.cat(parts), *new_states)
    return torch.cat(outs), merged


def _trunk_forward_prepared(module: Module, prepared: _TrunkPrepared, z, obs, states):
    """The prepared forward at lanes ``z``, blocked when the block divides
    the lanes and is smaller (the JAX package's rule)."""
    block = int(prepared.trunk_block)
    n = obs.shape[0]
    if block > 0 and n > block and n % block == 0:
        return _apply_trunk_delta_blocked(module, prepared.layers, z, obs, states, block)
    return _apply_trunk_delta(module, prepared.layers, z, obs, states)


def trunk_delta_forward(
    policy, params: TrunkDeltaParamsBatch, prepared: Optional[_TrunkPrepared], obs, states
) -> Tuple[torch.Tensor, Any]:
    """Whole-population shared-trunk forward, with :func:`lowrank_forward`'s
    contract (including the dense fallback, with a warning)."""
    module = policy.module
    if trunk_delta_supported(module):
        if prepared is None:
            prepared = prepare_trunk_delta(policy, params)
        return _trunk_forward_prepared(module, prepared, prepared.coeffs, obs, states)
    _fallback_warning("trunk-delta", params, module)
    return policy(params.materialize(), obs, states)
