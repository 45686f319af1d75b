"""The graftlint checkers of the port: nine static analyses of eager
PyTorch code (counterpart of ``evotorch_tpu/analysis/checkers.py``).

The JAX checkers guard compiled XLA programs: PRNG key reuse, retraces,
syncs under trace, donation, mesh axis names, x64 leaks, unsynced timing.
Eager torch has no trace, no keys and no donation, so each is redesigned
for what goes wrong in its place here rather than transliterated:

====================  =======================================================
checker               what it catches (JAX checker it replaces)
====================  =======================================================
``generator``         draws from torch's global generator, global seeding,
                      and a generator re-seeded to the same value every loop
                      iteration (``prng``)
``first-use``         ``torch.compile``/``torch.jit``, kernel builds or loads
                      that are not memoized, CUDA-graph captures in a loop
                      (``retrace``)
``host-sync``         device-to-host syncs in loop bodies and in the hot
                      modules (``host-sync``)
``input-mutation``    in-place writes to a functional program's inputs
                      (``donation``)
``process-group``     ``torch.distributed`` collectives without ``group=``
                      (``axis-name``)
``dtype``             global default dtypes, float64 in the hot modules
                      (``dtype``)
``timing``            clock reads around launches with no synchronizing read
                      in the region (``timing``)
``swallow``           broad exception handlers that neither report nor
                      re-raise (as JAX's)
``telemetry-schema``  hard-coded telemetry wire columns outside
                      ``observability/devicemetrics.py`` (as JAX's)
====================  =======================================================

Each checker's docstring states its rules. All are pure-AST (no imports
executed) and return :class:`~evotorch_tpu_torch.analysis.graftlint.Finding`
objects whose ``detail`` is the stable, line-independent part of the
signature. "Package code" below is a path under ``evotorch_tpu_torch/``; the
smoke test and the scripts are measurement harnesses and sync on purpose.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from .graftlint import Finding, ModuleInfo, ProjectInfo, dotted_name

__all__ = ["CHECKERS", "HOT_MODULES", "FUNCTIONAL_MODULES"]

_PACKAGE = "evotorch_tpu_torch/"

#: modules (or directories, ending in ``/``) whose every line runs on the hot
#: path of a generation: the eval engine and the policy forward, the
#: functional ask and tell, the sampler and the kernels, the rank, the server
HOT_MODULES = (
    "evotorch_tpu_torch/neuroevolution/net/vecrl.py",
    "evotorch_tpu_torch/neuroevolution/net/functional.py",
    "evotorch_tpu_torch/neuroevolution/net/layers.py",
    "evotorch_tpu_torch/neuroevolution/net/lowrank.py",
    "evotorch_tpu_torch/neuroevolution/net/runningnorm.py",
    "evotorch_tpu_torch/parallel/evaluate.py",
    "evotorch_tpu_torch/algorithms/functional/",
    "evotorch_tpu_torch/distributions.py",
    "evotorch_tpu_torch/ops/sampling.py",
    "evotorch_tpu_torch/ops/ranking.py",
    "evotorch_tpu_torch/tools/ranking.py",
    "evotorch_tpu_torch/serving/server.py",
)

#: the envs' directory: only their ``batch_step`` functions are hot
_ENVS = "evotorch_tpu_torch/envs/"

#: modules of functional programs: a function there returns new state and
#: leaves the tensors it was given as they were
FUNCTIONAL_MODULES = (
    "evotorch_tpu_torch/algorithms/functional/",
    "evotorch_tpu_torch/operators/functional.py",
    "evotorch_tpu_torch/neuroevolution/net/functional.py",
    "evotorch_tpu_torch/neuroevolution/net/lowrank.py",
    "evotorch_tpu_torch/neuroevolution/net/runningnorm.py",
    "evotorch_tpu_torch/neuroevolution/net/vecrl.py",
    "evotorch_tpu_torch/parallel/evaluate.py",
    "evotorch_tpu_torch/distributions.py",
    "evotorch_tpu_torch/tools/ranking.py",
)


def _in(path: str, prefixes) -> bool:
    return any(path == p or (p.endswith("/") and path.startswith(p)) for p in prefixes)


def _is_package(mod: ModuleInfo) -> bool:
    return mod.path.startswith(_PACKAGE)


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _enclosing_defs(mod: ModuleInfo, node: ast.AST) -> List[ast.AST]:
    out = []
    cur = getattr(node, "_gl_parent", None)
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out.append(cur)
        cur = getattr(cur, "_gl_parent", None)
    return out


def _params(fn: ast.AST) -> List[ast.arg]:
    """The named parameters (``*args`` is a fresh tuple and ``**kwargs`` a
    fresh dict of every call: neither is the caller's)."""
    args = fn.args
    return list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)


def _root_name(node: ast.AST) -> Optional[str]:
    """The name at the root of ``a.b[c].d``."""
    while isinstance(node, (ast.Attribute, ast.Subscript, ast.Starred)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


def _assigned_names(root: ast.AST) -> Set[str]:
    """Dotted names bound anywhere inside ``root`` (assignment targets, loop
    targets, ``with ... as`` and walrus targets)."""
    names: Set[str] = set()

    def add(target):
        for sub in ast.walk(target):
            if isinstance(sub, (ast.Name, ast.Attribute)):
                name = dotted_name(sub)
                if name:
                    names.add(name)

    for node in ast.walk(root):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                add(t)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.NamedExpr)):
            add(node.target)
        elif isinstance(node, (ast.For, ast.AsyncFor, ast.comprehension)):
            add(node.target)
        elif isinstance(node, ast.withitem) and node.optional_vars is not None:
            add(node.optional_vars)
    return names


# ---------------------------------------------------------------------------
# (a) generator discipline
# ---------------------------------------------------------------------------

#: torch functions that draw from a generator and take ``generator=``
_GLOBAL_DRAWS = {
    "torch.randn",
    "torch.rand",
    "torch.randint",
    "torch.randperm",
    "torch.normal",
    "torch.bernoulli",
    "torch.multinomial",
    "torch.poisson",
    "torch.randn_like",
    "torch.rand_like",
    "torch.randint_like",
}

#: in-place tensor methods that draw (``x.normal_()``; also ``torch.nn.init``'s)
_INPLACE_DRAWS = {
    "normal_",
    "uniform_",
    "bernoulli_",
    "exponential_",
    "random_",
    "cauchy_",
    "log_normal_",
    "geometric_",
}

#: process-wide seeding
_GLOBAL_SEEDS = {
    "torch.manual_seed",
    "torch.seed",
    "torch.random.manual_seed",
    "torch.random.seed",
    "torch.cuda.manual_seed",
    "torch.cuda.manual_seed_all",
}


def _loop_invariant(arg: ast.AST, assigned: Set[str]) -> bool:
    """True when ``arg`` takes the same value on every iteration of a loop
    that binds ``assigned``: it calls nothing and reads no name the loop
    binds."""
    for sub in ast.walk(arg):
        if isinstance(sub, ast.Call):
            return False
        if isinstance(sub, (ast.Name, ast.Attribute)):
            name = dotted_name(sub)
            if name is not None and (name in assigned or name.split(".")[0] in assigned):
                return False
    return True


def check_generator(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rules (the port draws only from explicit ``torch.Generator`` objects):

    1. In package code, a draw from torch's global generator: ``torch.randn``,
       ``rand``, ``randint``, ``randperm``, ``normal``, ``bernoulli``,
       ``multinomial``, ``poisson`` and the ``*_like`` forms, or an in-place
       draw (``x.normal_()``, ``uniform_``, ``bernoulli_``, ``exponential_``,
       ``random_``, ``cauchy_``, ``log_normal_``, ``geometric_``, also
       ``torch.nn.init``'s), without ``generator=``: the draw depends on
       whatever else used the global stream, so one seed no longer gives one
       run.
    2. In package code, ``torch.manual_seed``, ``torch.seed`` or
       ``torch.cuda.manual_seed[_all]``: library code must not reset the
       process's streams under its caller.
    3. Anywhere, ``g.manual_seed(x)`` or ``g.set_state(s)`` in a loop body on
       a generator made outside the loop, with an argument that is the same
       on every iteration: every iteration replays one stream, the
       counterpart of reusing a PRNG key.
    """
    findings: List[Finding] = []
    package = _is_package(mod)
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canon(node.func) or ""
        tail = node.func.attr if isinstance(node.func, ast.Attribute) else canon.rpartition(".")[2]
        unseeded = _kwarg(node, "generator") is None
        if package and unseeded and (canon in _GLOBAL_DRAWS or tail in _INPLACE_DRAWS):
            findings.append(
                mod.finding(
                    "generator",
                    node,
                    f"{tail}() without generator= draws from torch's global generator: pass the "
                    "caller's torch.Generator",
                    f"global-draw:{tail}",
                )
            )
            continue
        if package and canon in _GLOBAL_SEEDS:
            findings.append(
                mod.finding(
                    "generator",
                    node,
                    f"{canon}() reseeds the process's global streams under the caller: seed a "
                    "torch.Generator of your own",
                    f"global-seed:{tail}",
                )
            )
            continue
        if not (isinstance(node.func, ast.Attribute) and node.func.attr in ("manual_seed", "set_state")):
            continue
        receiver = dotted_name(node.func.value)
        if receiver is None or (mod.canon(node.func.value) or "").startswith("torch"):
            continue  # a generator made in the call (torch.Generator().manual_seed) or the torch module
        loops = mod.enclosing_loops(node)
        if not loops or not node.args:
            continue
        assigned = _assigned_names(loops[0])  # the innermost loop
        if receiver in assigned or receiver.split(".")[0] in assigned:
            continue  # the generator is made anew every iteration
        if all(_loop_invariant(a, assigned) for a in node.args):
            findings.append(
                mod.finding(
                    "generator",
                    node,
                    f"`{receiver}.{node.func.attr}(...)` in a loop with the same argument every "
                    "iteration: each iteration replays one stream — seed once outside the loop, "
                    "or vary the seed with the iteration",
                    f"loop-reseed:{receiver}",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# (b) first use: compiled plain versions, builds, graph captures
# ---------------------------------------------------------------------------

_COMPILERS = {"torch.compile", "torch.jit.script", "torch.jit.trace"}

_MEMO_DECORATORS = {"functools.lru_cache", "functools.cache"}

_EXTENSION_LOADS = {"torch.utils.cpp_extension.load", "torch.utils.cpp_extension.load_inline"}


def _result_is_cached(mod: ModuleInfo, call: ast.Call, fn: Optional[ast.AST]) -> bool:
    """True for a real memoizer (the JAX checker's test, kept): the call's
    result is stored into a subscript (``cache[key] = build(...)``, directly
    or through a name) somewhere in the enclosing function, or that function
    is decorated with ``functools.lru_cache``/``functools.cache`` (matched
    canonically: a decorator merely named like a cache does not memoize)."""
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        for dec in fn.decorator_list:
            target = dec.func if isinstance(dec, ast.Call) else dec
            if (mod.canon(target) or "") in _MEMO_DECORATORS:
                return True
    parent = getattr(call, "_gl_parent", None)
    assigned: Optional[str] = None
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        tgt = parent.targets[0]
        if isinstance(tgt, ast.Subscript):
            return True
        if isinstance(tgt, ast.Name):
            assigned = tgt.id
    if assigned is None or fn is None:
        return False
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for tgt in node.targets:
                if isinstance(tgt, ast.Subscript) and isinstance(node.value, ast.Name) and node.value.id == assigned:
                    return True
    return False


def check_first_use(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rules (first-use work that lands inside a generation, or a plain
    version compiled where the port's rule wants a hand-written kernel):

    1. ``torch.compile``, ``torch.jit.script`` or ``torch.jit.trace``
       anywhere: the port's kernels are written by hand, and a compiled
       plain version is not one (each new shape also recompiles mid-run).
    2. A kernel build or extension load: ``_build.build`` in a loop or in a
       function whose result is not memoized; ``_build.library`` in a loop
       (it memoizes by name itself, so a call after the first is a lookup);
       ``torch.utils.cpp_extension.load``/``load_inline`` in a loop or in a
       function whose result is not memoized. Memoized means the JAX
       checker's test: the result stored into a subscript, or the function
       under ``functools.lru_cache``/``cache``.
    3. A CUDA-graph capture (``torch.cuda.graph(...)``,
       ``X.capture_begin()``) in a loop body: every iteration captures a new
       graph instead of replaying one.
    """
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.Name, ast.Attribute)):
            canon = mod.canon(node)
            parent = getattr(node, "_gl_parent", None)
            if canon in _COMPILERS and not (isinstance(parent, ast.Attribute) and parent.value is node):
                findings.append(
                    mod.finding(
                        "first-use",
                        node,
                        f"{dotted_name(node)}: a compiled plain version is not a hand-written kernel, "
                        "and it recompiles at every new shape inside the run",
                        f"compiled:{canon}",
                    )
                )
            continue
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canon(node.func) or ""
        name = dotted_name(node.func) or ""
        loops = mod.enclosing_loops(node)
        fn = mod.enclosing_function(node)
        builds = name.endswith("_build.build") or canon in _EXTENSION_LOADS
        kind = None
        if (builds or name.endswith("_build.library")) and not _result_is_cached(mod, node, fn):
            kind = "in-loop" if loops else ("unmemoized" if builds and fn is not None else None)
        if kind is not None:
            where = "inside a loop" if kind == "in-loop" else "in a function whose result is not memoized"
            findings.append(
                mod.finding(
                    "first-use",
                    node,
                    f"{name}() {where}: the kernel is built or loaded again on every call — "
                    "memoize it (store it by key, or functools.cache)",
                    f"build-{kind}:{name.rsplit('.', 1)[-1]}",
                )
            )
            continue
        is_capture = canon == "torch.cuda.graph" or (
            isinstance(node.func, ast.Attribute) and node.func.attr == "capture_begin"
        )
        if is_capture and loops:
            findings.append(
                mod.finding(
                    "first-use",
                    node,
                    "CUDA-graph capture inside a loop: every iteration captures a new graph — "
                    "capture once outside the loop and replay it",
                    "capture-in-loop",
                )
            )
    return findings


# ---------------------------------------------------------------------------
# (c) host syncs
# ---------------------------------------------------------------------------

#: methods whose call copies a device value to the host or waits for it
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy", "nonzero", "masked_select", "synchronize"}

#: torch functions that sync (one-argument ``torch.where`` is handled apart)
_SYNC_FUNCS = {"torch.nonzero", "torch.masked_select", "torch.unique", "torch.cuda.synchronize"}

#: tensor methods whose result is a tensor (a reduction or a test), so that
#: ``float()``/``int()``/``bool()``/``if`` of one reads the device
_TENSOR_METHODS = {
    "sum", "mean", "max", "min", "amax", "amin", "any", "all", "norm", "abs", "std", "var",
    "prod", "count_nonzero", "argmax", "argmin", "isfinite", "isnan", "median", "dot",
    "logsumexp", "cumsum", "square", "sqrt", "exp", "log", "eq", "ne", "gt", "ge", "lt", "le",
}

#: torch namespaces and functions that return host values
_HOST_TORCH = (
    "torch.cuda.",
    "torch.backends.",
    "torch.distributed.",
    "torch.is_",
    "torch.get_",
    "torch.numel",
    "torch.finfo",
    "torch.iinfo",
    "torch.device",
    "torch.Size",
    "torch.are_deterministic_algorithms_enabled",
)


def _is_host_module_expr(mod: ModuleInfo, node: ast.AST) -> bool:
    """True for an expression rooted in a module imported here that is not
    torch (``np.sqrt``, ``math.isfinite``, ``np.asarray(x).sum``): numpy
    and the stdlib share the tensor methods' names."""
    while isinstance(node, (ast.Attribute, ast.Call, ast.Subscript)):
        node = node.func if isinstance(node, ast.Call) else node.value
    if not isinstance(node, ast.Name) or node.id not in mod.aliases:
        return False
    return not (mod.canon(node) or "").startswith("torch")


def _is_tensor_expr(mod: ModuleInfo, node: ast.AST) -> bool:
    """A static guess that ``node`` evaluates to a tensor: a ``torch.*``
    call that returns one, a tensor method (a reduction or a test) on
    anything but a numpy or stdlib expression, or a comparison, boolean or
    ``not`` over such."""
    if isinstance(node, ast.Call):
        canon = mod.canon(node.func) or ""
        if canon.startswith("torch.") and not canon.startswith(_HOST_TORCH):
            return True
        return (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _TENSOR_METHODS
            and not _is_host_module_expr(mod, node.func)
        )
    if isinstance(node, ast.Compare):
        return any(_is_tensor_expr(mod, x) for x in [node.left, *node.comparators])
    if isinstance(node, ast.BoolOp):
        return any(_is_tensor_expr(mod, x) for x in node.values)
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, ast.Not):
        return _is_tensor_expr(mod, node.operand)
    return False


def _to_host(node: ast.Call) -> bool:
    """``x.to("cpu", ...)`` or ``x.to(device="cpu")``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr == "to"):
        return False
    target = node.args[0] if node.args else _kwarg(node, "device")
    return isinstance(target, ast.Constant) and target.value == "cpu"


def _sync_detail(mod: ModuleInfo, node: ast.Call) -> Optional[str]:
    """What kind of host sync the call ``node`` is, or None."""
    canon = mod.canon(node.func) or ""
    if canon in _SYNC_FUNCS:
        return canon.rsplit(".", 1)[-1]
    if isinstance(node.func, ast.Attribute) and node.func.attr in _SYNC_METHODS:
        receiver = node.func.value
        if node.func.attr == "numpy" and isinstance(receiver, ast.Call) and _sync_detail(mod, receiver):
            return None  # ``x.cpu().numpy()``: the copy is the ``cpu()``, counted there
        if node.func.attr in ("synchronize", "masked_select") or not node.args:
            return node.func.attr
    if _to_host(node):
        return "to-cpu"
    if canon == "torch.where" and len(node.args) == 1 and not node.keywords:
        return "where-1arg"
    if (
        isinstance(node.func, ast.Name)
        and node.func.id in ("float", "int", "bool")
        and len(node.args) == 1
        and _is_tensor_expr(mod, node.args[0])
    ):
        return f"{node.func.id}-of-tensor"
    return None


def _syncing_helpers(mod: ModuleInfo) -> Set[str]:
    """This module's top-level functions whose own body syncs (a def nested
    in one is not its body: it syncs when it is called)."""
    cached = getattr(mod, "_gl_sync_helpers", None)
    if cached is None:
        cached = {
            name
            for name, fn in mod.defs.items()
            if any(
                isinstance(n, ast.Call) and mod.enclosing_function(n) is fn and _sync_detail(mod, n)
                for n in ast.walk(fn)
            )
        }
        mod._gl_sync_helpers = cached  # type: ignore[attr-defined]
    return cached


def _is_hot(mod: ModuleInfo, node: ast.AST) -> bool:
    if _in(mod.path, HOT_MODULES):
        return True
    if mod.path.startswith(_ENVS):
        return any(fn.name == "batch_step" for fn in _enclosing_defs(mod, node))
    return False


def check_host_sync(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rules, in package code, inside any loop body and anywhere in
    :data:`HOT_MODULES` (and the envs' ``batch_step``): a call that makes the
    host wait for the card.

    1. ``.item()``, ``.tolist()``, ``.cpu()``, ``.to("cpu")``, ``.numpy()``,
       ``.nonzero()``, ``.masked_select()``, ``.synchronize()``
       (``torch.cuda``'s, an event's or a stream's), ``torch.nonzero``,
       ``torch.masked_select``, ``torch.unique`` and one-argument
       ``torch.where``: each copies a device value to the host or waits for
       the card (the last four size their output by the data).
    2. ``float()``, ``int()`` or ``bool()`` of a tensor expression, and
       ``if``/``while`` on one (a ``torch.*`` call, a tensor reduction or
       test, or a comparison over one). A ``while`` on one is flagged
       wherever it is: it syncs once an iteration.
    3. In a loop body, a call of a function of the same module whose own
       body makes such a sync (``out = _actions_to_host(out)``).

    The syncs the records count on purpose (``PERF.md`` §5: ``episodes``'
    one a generation, the host pipeline's one a control step, the server's
    one a dispatch) carry an allow comment whose reason names that count.
    """
    if not _is_package(mod):
        return []
    findings: List[Finding] = []

    def scoped(node) -> bool:
        return bool(mod.enclosing_loops(node)) or _is_hot(mod, node)

    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.If, ast.While)) and _is_tensor_expr(mod, node.test):
            # a `while` on a tensor syncs once an iteration wherever it is
            if isinstance(node, ast.While) or scoped(node):
                findings.append(
                    mod.finding(
                        "host-sync",
                        node.test,
                        f"`{type(node).__name__.lower()}` on a tensor reads it on the host: the "
                        "host waits for the card here",
                        f"branch-on-tensor:{type(node).__name__.lower()}",
                    )
                )
            continue
        if not isinstance(node, ast.Call) or not scoped(node):
            continue
        detail = _sync_detail(mod, node)
        if detail is None and isinstance(node.func, ast.Name) and node.func.id in _syncing_helpers(mod):
            if mod.enclosing_loops(node):
                detail = f"via:{node.func.id}"
        if detail is None:
            continue
        findings.append(
            mod.finding(
                "host-sync",
                node,
                f"{dotted_name(node.func) or detail}() "
                f"{'in a loop body' if mod.enclosing_loops(node) else 'on the hot path'}: the host "
                "waits for the card here — keep the value on the device, or count the sync",
                f"sync:{detail}",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# (d) writes to a functional program's inputs
# ---------------------------------------------------------------------------

_NUMBER_ANNOTATIONS = {"int", "float", "bool", "str"}


def _mutable_params(fn: ast.AST) -> Set[str]:
    """Parameters that may hold a tensor: all but ``self``/``cls``, ``out``,
    and those annotated or defaulted as a Python number or string."""
    args = fn.args
    positional = list(args.posonlyargs) + list(args.args)
    defaults = dict(zip([a.arg for a in positional[len(positional) - len(args.defaults):]], args.defaults))
    defaults.update({a.arg: d for a, d in zip(args.kwonlyargs, args.kw_defaults) if d is not None})
    names = set()
    for a in _params(fn):
        if a.arg in ("self", "cls", "out"):
            continue
        ann = a.annotation
        if isinstance(ann, ast.Name) and ann.id in _NUMBER_ANNOTATIONS:
            continue
        if isinstance(ann, ast.Constant) and ann.value in _NUMBER_ANNOTATIONS:
            continue
        default = defaults.get(a.arg)
        if isinstance(default, ast.Constant) and isinstance(default.value, (int, float, str)) and default.value is not None:
            continue
        names.add(a.arg)
    return names


def _rebound_lines(fn: ast.AST, name: str) -> List[int]:
    """Lines where ``name`` itself is bound again inside ``fn``."""
    lines = []
    for node in ast.walk(fn):
        targets = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AnnAssign, ast.NamedExpr)):
            targets = [node.target]
        elif isinstance(node, (ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, ast.withitem) and node.optional_vars is not None:
            targets = [node.optional_vars]
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name) and sub.id == name and isinstance(sub.ctx, ast.Store):
                    lines.append(getattr(node, "lineno", getattr(t, "lineno", 0)))
    return lines


def _writes(node: ast.AST) -> list:
    """``(target, how)`` for each in-place write the node ``node`` makes."""
    if isinstance(node, ast.Call):
        out = []
        attr = node.func.attr if isinstance(node.func, ast.Attribute) else ""
        if attr.endswith("_") and not attr.startswith("_"):
            out.append((node.func.value, f".{attr}()"))
        if _kwarg(node, "out") is not None:
            out.append((_kwarg(node, "out"), "out="))
        return out
    if isinstance(node, ast.Assign):
        return [(t, "item assignment") for t in node.targets if isinstance(t, ast.Subscript)]
    if isinstance(node, ast.AugAssign):
        return [(node.target, "augmented assignment")]
    return []


def check_input_mutation(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rule, in :data:`FUNCTIONAL_MODULES` (the static side of the program
    ledger's ``_version`` check, ``observability/programs.py``): a function
    writes in place to one of its parameters or to a field of one, with an
    in-place method (a name ending in ``_``, such as ``add_``, ``copy_``,
    ``index_put_``), an item or slice assignment (``x[...] = ...``), an
    augmented assignment (``x += ...``, in place for a tensor) or ``out=x``.
    A functional program returns new state and leaves its inputs alone: the
    caller may hold them (the previous state, a shared statistic).
    ``self``, parameters named ``out``, parameters annotated or defaulted as
    a Python number or string, and a parameter rebound earlier in the
    function are exempt.
    """
    if not _in(mod.path, FUNCTIONAL_MODULES):
        return []
    findings: List[Finding] = []
    for fn in ast.walk(mod.tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        params = _mutable_params(fn)
        if not params:
            continue
        rebound = {p: _rebound_lines(fn, p) for p in params}

        def is_input(target: ast.AST, line: int) -> Optional[str]:
            root = _root_name(target)
            if root in params and not any(r < line for r in rebound[root]):
                return root
            return None

        for node in ast.walk(fn):
            if mod.enclosing_function(node) is not fn:
                continue  # a nested def is checked against its own parameters
            for target, how in _writes(node):
                hit = is_input(target, node.lineno)
                if hit is not None:
                    findings.append(
                        mod.finding(
                            "input-mutation",
                            node,
                            f"`{fn.name}` writes its input `{hit}` in place ({how}): a functional "
                            "program returns new state and leaves the tensors it was given alone",
                            f"writes-input:{hit}",
                        )
                    )
                    break
    return findings


# ---------------------------------------------------------------------------
# (e) process groups
# ---------------------------------------------------------------------------

#: collective -> the positional index of its ``group`` argument
_COLLECTIVES = {
    "all_reduce": 2,
    "all_gather": 2,
    "all_gather_into_tensor": 2,
    "all_gather_object": 2,
    "broadcast": 2,
    "broadcast_object_list": 2,
    "reduce_scatter": 3,
    "reduce_scatter_tensor": 3,
    "all_to_all": 2,
    "all_to_all_single": 4,
    "barrier": 0,
    "send": 2,
    "recv": 2,
}

_MESH_MODULE = "evotorch_tpu_torch/parallel/mesh.py"


def check_process_group(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rule: a ``torch.distributed`` collective (``all_reduce``,
    ``all_gather*``, ``broadcast*``, ``reduce_scatter*``, ``all_to_all*``,
    ``barrier``, ``send``, ``recv``) without ``group=`` (by keyword or
    position), outside ``parallel/mesh.py``, whose helpers own the world
    group: it runs over every rank of the world instead of the mesh's group,
    and a mesh over fewer ranks (``parallel.mesh.sub_mesh``) then hangs or
    mixes ranks that are not its own."""
    if mod.path == _MESH_MODULE:
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Call):
            continue
        canon = mod.canon(node.func) or ""
        if not canon.startswith("torch.distributed."):
            continue
        name = canon.rsplit(".", 1)[-1]
        position = _COLLECTIVES.get(name)
        if position is None or _kwarg(node, "group") is not None or len(node.args) > position:
            continue
        findings.append(
            mod.finding(
                "process-group",
                node,
                f"{dotted_name(node.func)}() without group= runs over the whole world, not the "
                "mesh's group: pass mesh.group",
                f"world-collective:{name}",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# (f) dtypes
# ---------------------------------------------------------------------------


def check_dtype(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rules:

    1. ``torch.set_default_dtype`` anywhere: it changes every later tensor
       of the process, the counterpart of ``jax_enable_x64``.
    2. ``torch.float64``, ``torch.double`` or ``.double()`` in
       :data:`HOT_MODULES` (and the envs' ``batch_step``): float64 runs at a
       sixtieth of the float32 rate on the card and re-promotes the f32/bf16
       compute path.
    """
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call):
            canon = mod.canon(node.func) or ""
            if canon == "torch.set_default_dtype":
                findings.append(
                    mod.finding(
                        "dtype",
                        node,
                        "torch.set_default_dtype changes the dtype of every later tensor in the "
                        "process: pass dtype= where the tensor is made",
                        "set-default-dtype",
                    )
                )
            elif (
                isinstance(node.func, ast.Attribute)
                and node.func.attr == "double"
                and not node.args
                and _is_hot(mod, node)
            ):
                findings.append(
                    mod.finding(
                        "dtype",
                        node,
                        ".double() on the hot path: float64 re-promotes the f32/bf16 compute "
                        "path and runs at a fraction of the float32 rate",
                        "x64:double()",
                    )
                )
        elif isinstance(node, ast.Attribute):
            canon = mod.canon(node)
            if canon in ("torch.float64", "torch.double") and _is_hot(mod, node):
                findings.append(
                    mod.finding(
                        "dtype",
                        node,
                        f"{dotted_name(node)} on the hot path: float64 re-promotes the f32/bf16 "
                        "compute path and runs at a fraction of the float32 rate",
                        f"x64:{canon.rsplit('.', 1)[-1]}",
                    )
                )
    return findings


# ---------------------------------------------------------------------------
# (g) unsynced timing
# ---------------------------------------------------------------------------

#: wall-clock sources a measured region starts and ends with
_TIME_FUNCS = {
    "time.perf_counter",
    "time.perf_counter_ns",
    "time.time",
    "time.time_ns",
    "time.monotonic",
    "time.monotonic_ns",
    "time.process_time",
}

#: method calls that make the host wait for the card
_SYNC_READS = {"synchronize", "elapsed_time", "item", "cpu", "tolist"}


def _port_names(mod: ModuleInfo) -> Set[str]:
    """Names this module imports from the port, absolutely
    (``from evotorch_tpu_torch.x import f``) or, inside the package,
    relatively (``from ..x import f``)."""
    names: Set[str] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ImportFrom):
            absolute = node.level == 0 and (node.module or "").split(".")[0] == "evotorch_tpu_torch"
            if absolute or (node.level > 0 and _is_package(mod)):
                names.update(a.asname or a.name for a in node.names if a.name != "*")
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "evotorch_tpu_torch":
                    names.add(a.asname or a.name.split(".")[0])
    return names


def _launches(mod: ModuleInfo, call: ast.Call, port: Set[str]) -> Optional[str]:
    """The name of what ``call`` launches, when it calls torch or the port."""
    canon = mod.canon(call.func) or ""
    if canon.startswith("torch.") and not canon.startswith(_HOST_TORCH):
        return canon
    name = dotted_name(call.func)
    if name is not None and name.split(".")[0] in port:
        return name
    return None


def _is_sync_read(mod: ModuleInfo, call: ast.Call) -> bool:
    if mod.canon(call.func) == "torch.cuda.synchronize":
        return True
    return isinstance(call.func, ast.Attribute) and call.func.attr in _SYNC_READS


def _resolve_local_def(mod: ModuleInfo, scope: ast.AST, name: str) -> Optional[ast.AST]:
    """A FunctionDef named ``name`` visible from ``scope`` (nearest enclosing
    scope first, then module level)."""
    cur: Optional[ast.AST] = scope
    while cur is not None:
        if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Module)):
            for stmt in cur.body:
                if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name == name:
                    return stmt
        cur = getattr(cur, "_gl_parent", None)
    return None


def check_timing(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rule: CUDA launches are asynchronous, so ``t0 = time.perf_counter();
    work(); dt = time.perf_counter() - t0`` measures how fast the host
    queued the work, not how long the card took. A region between two or
    more ``time.*()`` reads of one scope that calls ``torch.*`` or a name
    imported from the port, with no synchronizing read in the region or in
    a local helper it calls, is flagged. Synchronizing reads are
    ``torch.cuda.synchronize()``, ``Event.synchronize()`` and
    ``elapsed_time``, ``.item()``, ``.cpu()`` and ``.tolist()``. Nested defs
    are their own scopes; a def merely defined in the region neither
    launches nor syncs."""
    findings: List[Finding] = []
    port = _port_names(mod)
    scopes: List[ast.AST] = [mod.tree]
    scopes += [n for n in ast.walk(mod.tree) if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    for scope in scopes:
        owner = scope if scope is not mod.tree else None
        calls = [n for n in ast.walk(scope) if isinstance(n, ast.Call) and mod.enclosing_function(n) is owner]
        time_calls = [c for c in calls if (mod.canon(c.func) or "") in _TIME_FUNCS]
        if len(time_calls) < 2:
            continue
        first = min(c.lineno for c in time_calls)
        last = max(c.lineno for c in time_calls)
        launched: List[str] = []
        synced = False
        for node in calls:
            if not (first <= node.lineno <= last):
                continue
            if _is_sync_read(mod, node):
                synced = True
                break
            what = _launches(mod, node, port)
            if what is not None:
                launched.append(what)
                continue
            if isinstance(node.func, ast.Name):
                local = _resolve_local_def(mod, scope, node.func.id)
                if local is None:
                    continue
                inner = [n for n in ast.walk(local) if isinstance(n, ast.Call)]
                if any(_is_sync_read(mod, n) for n in inner):
                    synced = True
                    break
                if any(_launches(mod, n, port) for n in inner):
                    launched.append(node.func.id)
        if synced or not launched:
            continue
        callee = sorted(set(launched))[0]
        findings.append(
            mod.finding(
                "timing",
                time_calls[-1],
                f"time.*() measurement around `{callee}` with no synchronizing read in the region: "
                "CUDA launches are asynchronous, so this measures the launch queue — "
                "torch.cuda.synchronize() (or an event) before reading the clock",
                f"unsynced-timing:{callee}",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# (h) silently swallowed exceptions (as the JAX package's)
# ---------------------------------------------------------------------------


#: broad exception classes whose handlers must not be silent
_SWALLOW_BROAD = {"Exception", "BaseException"}

#: a call whose final attribute is one of these counts as reporting the
#: failure: stdlib logging/warnings/print, traceback capture, and the
#: registry counters (a counted degradation is observable, not silent)
_SWALLOW_REPORTERS = {
    "print", "debug", "info", "warning", "warn", "error", "exception",
    "critical", "log", "format_exc", "print_exc", "increment", "accumulate",
    "observe_max", "instant", "fail", "skip",
}


def _swallow_broad_handler(mod: ModuleInfo, handler: ast.ExceptHandler) -> Optional[str]:
    """The label to report for a broad handler, or None for a narrow one."""
    t = handler.type
    if t is None:
        return "bare except"
    types = list(t.elts) if isinstance(t, ast.Tuple) else [t]
    for node in types:
        name = mod.canon(node) or dotted_name(node) or ""
        if name.rpartition(".")[2] in _SWALLOW_BROAD:
            return f"except {name.rpartition('.')[2]}"
    return None


def _swallow_handler_reports(mod: ModuleInfo, handler: ast.ExceptHandler) -> bool:
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Raise):
                return True
            if isinstance(node, ast.Call):
                name = mod.canon(node.func) or dotted_name(node.func) or ""
                if name.rpartition(".")[2] in _SWALLOW_REPORTERS:
                    return True
                if "logg" in name.lower():  # logger.*/logging.* helpers
                    return True
    return False


def check_swallow(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rule (as the JAX package's): a broad exception handler (bare
    ``except``, ``except Exception``/``BaseException``) that neither logs,
    counts nor re-raises: the failure degrades silently. In the port this
    matters most around a kernel build or launch, where a swallowed error
    would be a hidden fallback."""
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        label = _swallow_broad_handler(mod, node)
        if label is None or _swallow_handler_reports(mod, node):
            continue
        findings.append(
            mod.finding(
                "swallow",
                node,
                f"{label} neither logs, counts, nor re-raises — the failure "
                "degrades silently; report it, re-raise, or annotate "
                "`# graftlint: allow(swallow): reason`",
                f"swallow:{label}",
            )
        )
    return findings


# ---------------------------------------------------------------------------
# (i) telemetry wire-schema literals (as the JAX package's)
# ---------------------------------------------------------------------------

#: the single module allowed to spell raw telemetry column indices: it OWNS
#: the wire schema (TELEMETRY_SCHEMA_VERSION and the column-layout constants)
_TELEMETRY_SCHEMA_OWNER = "evotorch_tpu_torch/observability/devicemetrics.py"

#: bare names that carry the raw int32 telemetry wire even without
#: "telemetry" in their spelling (the decoded per-group/per-lane matrices)
_TELEMETRY_WIRE_NAMES = {"group_counts", "lane_counts"}


def _telemetry_wire_base(node: ast.Subscript) -> Optional[str]:
    """Dotted name of the subscripted expression when it looks like a raw
    telemetry wire array; unwraps chained subscripts (``telemetry[g][15]``)."""
    base: ast.AST = node.value
    while isinstance(base, ast.Subscript):
        base = base.value
    name = dotted_name(base)
    if name is None:
        return None
    if "telemetry" in name.lower():
        return name
    if name.rpartition(".")[2] in _TELEMETRY_WIRE_NAMES:
        return name
    return None


def check_telemetry_schema(mod: ModuleInfo, project: ProjectInfo) -> List[Finding]:
    """Rule (as the JAX package's): the telemetry matrix layout is versioned
    (schema v1 ``(6,)`` through v4 ``(G, 20)``); a hard-coded column index
    outside ``observability/devicemetrics.py`` is a latent decode bug: it
    silently reads the wrong counter the next time a column is inserted.
    Index through the named layout constants or the decoded
    ``GroupTelemetry`` fields instead."""
    if mod.path == _TELEMETRY_SCHEMA_OWNER:
        return []
    findings: List[Finding] = []
    for node in ast.walk(mod.tree):
        if not isinstance(node, ast.Subscript):
            continue
        base = _telemetry_wire_base(node)
        if base is None:
            continue
        literals = sorted(
            {
                n.value
                for n in ast.walk(node.slice)
                if isinstance(n, ast.Constant) and isinstance(n.value, int) and not isinstance(n.value, bool)
            }
        )
        if not literals:
            continue
        lits = ",".join(str(v) for v in literals)
        findings.append(
            mod.finding(
                "telemetry-schema",
                node,
                f"hard-coded telemetry column index [{lits}] on `{base}`: the "
                "wire layout is schema-versioned and owned by "
                "observability/devicemetrics.py — index via its named layout "
                "constants or the decoded GroupTelemetry accessors, or "
                "annotate `# graftlint: allow(telemetry-schema): reason`",
                f"telemetry-index:{base}:[{lits}]",
            )
        )
    return findings


CHECKERS = {
    "generator": check_generator,
    "first-use": check_first_use,
    "host-sync": check_host_sync,
    "input-mutation": check_input_mutation,
    "process-group": check_process_group,
    "dtype": check_dtype,
    "timing": check_timing,
    "swallow": check_swallow,
    "telemetry-schema": check_telemetry_schema,
}
