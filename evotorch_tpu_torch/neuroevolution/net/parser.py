"""``str_to_net``: the network-specification mini-language (counterpart of
``evotorch_tpu/neuroevolution/net/parser.py``).

A string such as ``"Linear(obs_length, 64) >> Tanh() >> Linear(64,
act_length)"`` is parsed with Python's ``ast`` and evaluated by a small
whitelist evaluator (never ``eval``): calls of the port's layer names,
``>>``, arithmetic on numbers, and names given as keyword arguments (the
problem's constants, e.g. ``obs_length`` and ``act_length``). Every layer
of the JAX package's DSL is ported, the recurrent cells and the structured
nets included.
"""

from __future__ import annotations

import ast
from typing import Any, Dict

from . import layers as _layers
from .layers import Module

__all__ = ["NetParsingError", "str_to_net"]


class NetParsingError(Exception):
    """A parse or evaluation failure, with the source string."""

    def __init__(self, message: str, source: str = ""):
        super().__init__(f"{message}\n  while parsing: {source}" if source else message)


_SAFE_FUNCS: Dict[str, Any] = {
    name: getattr(_layers, name)
    for name in _layers.__all__
    if isinstance(getattr(_layers, name), type)
    and issubclass(getattr(_layers, name), Module)
    and name not in ("Apply", "FrozenModule", "Module")
}
_SAFE_CONSTS: Dict[str, Any] = {
    "True": True,
    "False": False,
    "None": None,
    "inf": float("inf"),
    "nan": float("nan"),
    "pi": 3.141592653589793,
}
_BINARY_OPS = {
    ast.Add: lambda a, b: a + b,
    ast.Sub: lambda a, b: a - b,
    ast.Mult: lambda a, b: a * b,
    ast.Div: lambda a, b: a / b,
    ast.FloorDiv: lambda a, b: a // b,
    ast.Pow: lambda a, b: a**b,
    ast.Mod: lambda a, b: a % b,
}


def _eval_node(node: ast.AST, names: Dict[str, Any], source: str) -> Any:
    if isinstance(node, ast.Expression):
        return _eval_node(node.body, names, source)
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.RShift):
        left = _eval_node(node.left, names, source)
        right = _eval_node(node.right, names, source)
        if not isinstance(left, Module) or not isinstance(right, Module):
            raise NetParsingError(">> expects layers on both sides", source)
        return left >> right
    if isinstance(node, ast.BinOp):
        op = _BINARY_OPS.get(type(node.op))
        if op is None:
            raise NetParsingError(f"Unsupported operator: {ast.dump(node.op)}", source)
        return op(_eval_node(node.left, names, source), _eval_node(node.right, names, source))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.USub):
        return -_eval_node(node.operand, names, source)
    if isinstance(node, ast.Call):
        if not isinstance(node.func, ast.Name):
            raise NetParsingError("Only simple layer names may be called", source)
        func_name = node.func.id
        if func_name not in _SAFE_FUNCS:
            raise NetParsingError(f"Unknown layer type: {func_name!r} (known: {sorted(_SAFE_FUNCS)})", source)
        args = [_eval_node(a, names, source) for a in node.args]
        kwargs = {kw.arg: _eval_node(kw.value, names, source) for kw in node.keywords}
        return _SAFE_FUNCS[func_name](*args, **kwargs)
    if isinstance(node, ast.Name):
        if node.id in names:
            return names[node.id]
        if node.id in _SAFE_CONSTS:
            return _SAFE_CONSTS[node.id]
        raise NetParsingError(f"Unknown name: {node.id!r}", source)
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, (ast.Tuple, ast.List)):
        return [_eval_node(e, names, source) for e in node.elts]
    raise NetParsingError(f"Unsupported syntax: {ast.dump(node)}", source)


def str_to_net(s: str, **constants) -> Module:
    """Parse a network string into a Module, e.g.
    ``str_to_net("Linear(obs_length, 16) >> Tanh() >> Linear(16, act_length)",
    obs_length=4, act_length=2)``."""
    try:
        tree = ast.parse(s.strip(), mode="eval")
    except SyntaxError as e:
        raise NetParsingError(f"Invalid network string: {e}", s) from e
    result = _eval_node(tree, dict(constants), s)
    if not isinstance(result, Module):
        raise NetParsingError(f"Network string evaluated to {type(result).__name__}, not a layer", s)
    return result
