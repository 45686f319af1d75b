"""graftlint: the AST lint of the port (counterpart of
``evotorch_tpu/analysis/graftlint.py``).

The port runs evolution as eager PyTorch on the card, so its worst faults
are the ones Python never raises: a draw from torch's global generator
that makes two runs of one seed differ, a host sync hiding in the eager
control-step loop, a functional program that writes the tensors it was
given, a collective that runs over the whole world instead of its mesh's
group, a timing that measures the launch queue and not the card. This
module is the machinery, kept equal to the JAX package's where it is
language-agnostic: finding and baseline bookkeeping, module parsing
(import-alias resolution, symbol tables) and the runner. The checkers live
in :mod:`evotorch_tpu_torch.analysis.checkers`; the runtime counterpart
(first-use counting) in :mod:`evotorch_tpu_torch.analysis.retrace_sentinel`.

Pure stdlib (``ast``/``json``): linting imports neither torch nor the code
it reads, so it runs in milliseconds per file and needs no card.

Baselines: a finding's :attr:`Finding.signature` leaves out the line
number, so unrelated edits moving code around do not churn
``baseline.json``; matching is multiset-aware (two identical-signature
findings need two baseline entries).

Scoped exemptions: a ``# graftlint: allow(<checker>): <reason>`` comment on
(or immediately above) the offending line suppresses that checker there,
the in-code alternative to a baseline entry for an intentional violation
(e.g. the one host sync a generation of the ``episodes`` contract counts on).
The reason is mandatory: a reasonless allow is itself reported as a
``lint-allow`` finding.
"""

from __future__ import annotations

import ast
import io
import json
import re
import tokenize
from collections import Counter
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

__all__ = [
    "Finding",
    "ModuleInfo",
    "ProjectInfo",
    "run_lint",
    "lint_sources",
    "load_baseline",
    "save_baseline",
    "apply_baseline",
    "default_targets",
    "default_baseline_path",
    "repo_root",
    "scoped_allows",
]


# ---------------------------------------------------------------------------
# findings + baseline
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Finding:
    """One lint finding. ``detail`` is the stable, line-independent part of
    the identity (typically the offending symbol/pattern), so baselines
    survive unrelated line drift."""

    checker: str
    path: str  # repo-relative posix path
    line: int
    symbol: str  # enclosing function qualname, or "<module>"
    message: str
    detail: str = ""

    @property
    def signature(self) -> str:
        return f"{self.path}::{self.checker}::{self.symbol}::{self.detail}"

    def format(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.symbol}: {self.message}"

    def to_json(self) -> dict:
        return {
            "checker": self.checker,
            "path": self.path,
            "line": self.line,
            "symbol": self.symbol,
            "message": self.message,
            "detail": self.detail,
            "signature": self.signature,
        }


def load_baseline(path) -> List[dict]:
    """Baseline file: ``{"findings": [{"signature": ..., "reason": ...}]}``."""
    data = json.loads(Path(path).read_text())
    return list(data.get("findings", []))


def save_baseline(path, findings: Sequence[Finding], *, reasons: Optional[dict] = None):
    reasons = reasons or {}
    entries = [
        {
            "signature": f.signature,
            "reason": reasons.get(f.signature, ""),
            # message kept for human readers only; matching is by signature
            "message": f.message,
        }
        for f in sorted(findings, key=lambda f: (f.path, f.checker, f.line))
    ]
    Path(path).write_text(json.dumps({"findings": entries}, indent=2) + "\n")


def apply_baseline(
    findings: Sequence[Finding], baseline: Sequence[dict]
) -> Tuple[List[Finding], List[dict]]:
    """Split findings into (new, stale-baseline-entries). Multiset matching:
    each baseline entry absorbs at most one finding with its signature."""
    budget = Counter(e["signature"] for e in baseline)
    new: List[Finding] = []
    for f in findings:
        if budget.get(f.signature, 0) > 0:
            budget[f.signature] -= 1
        else:
            new.append(f)
    stale_sigs = Counter()
    for sig, n in budget.items():
        if n > 0:
            stale_sigs[sig] = n
    stale = []
    seen: Counter = Counter()
    for e in baseline:
        sig = e["signature"]
        if seen[sig] < stale_sigs.get(sig, 0):
            stale.append(e)
            seen[sig] += 1
    return new, stale


# ---------------------------------------------------------------------------
# scoped allow-comments
# ---------------------------------------------------------------------------

#: `# graftlint: allow(checker[, checker...])` with an optional `: reason`
_ALLOW_RE = re.compile(
    r"#\s*graftlint:\s*allow\(\s*([a-z0-9_\-\s,]+?)\s*\)\s*(?::\s*(\S.*))?$"
)


def scoped_allows(path: str, source: str) -> Tuple[Dict[int, set], List[Finding]]:
    """Parse ``# graftlint: allow(...)`` comments (real COMMENT tokens only —
    allow-syntax inside string literals is inert). Returns
    ``({line: {checker, ...}}, reasonless-allow findings)``. A trailing allow
    covers its own line; a standalone allow-comment line covers the next
    line — never both, so one allow cannot silently wave through an
    adjacent, unrelated violation."""
    allows: Dict[int, set] = {}
    problems: List[Finding] = []
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(source).readline))
    except (tokenize.TokenError, IndentationError, SyntaxError):
        return allows, problems  # unparsable source is reported elsewhere
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _ALLOW_RE.search(tok.string)
        if m is None:
            continue
        lineno = tok.start[0]
        checkers = {c.strip() for c in m.group(1).split(",") if c.strip()}
        if not m.group(2):
            problems.append(
                Finding(
                    checker="lint-allow",
                    path=path,
                    line=lineno,
                    symbol="<comment>",
                    message=(
                        "graftlint allow-comment without a reason — write"
                        " `# graftlint: allow(<checker>): <why this is"
                        " intentional>`"
                    ),
                    detail="missing-reason",
                )
            )
            continue
        trailing = bool(tok.line[: tok.start[1]].strip())  # code before the '#'
        covered = lineno if trailing else lineno + 1
        allows.setdefault(covered, set()).update(checkers)
    return allows, problems


def _apply_scoped_allows(
    findings: List[Finding], allows_by_path: Dict[str, Dict[int, set]]
) -> List[Finding]:
    kept = []
    for f in findings:
        allowed = allows_by_path.get(f.path, {}).get(f.line, ())
        if f.checker not in allowed:
            kept.append(f)
    return kept


# ---------------------------------------------------------------------------
# module / project models
# ---------------------------------------------------------------------------


def _attach_parents(tree: ast.AST) -> None:
    for node in ast.walk(tree):
        for child in ast.iter_child_nodes(node):
            child._gl_parent = node  # type: ignore[attr-defined]


def dotted_name(node: ast.AST) -> Optional[str]:
    """``a.b.c`` for a Name/Attribute chain, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


@dataclass
class ModuleInfo:
    path: str  # repo-relative posix
    tree: ast.Module
    aliases: Dict[str, str] = field(default_factory=dict)
    # top-level function defs (incl. simple `x = y` aliases of them)
    defs: Dict[str, ast.AST] = field(default_factory=dict)
    name_aliases: Dict[str, str] = field(default_factory=dict)

    @classmethod
    def parse(cls, path: str, source: str) -> "ModuleInfo":
        tree = ast.parse(source, filename=path)
        _attach_parents(tree)
        info = cls(path=path, tree=tree)
        info._collect_imports()
        info._collect_defs()
        return info

    def _collect_imports(self) -> None:
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.aliases[a.asname or a.name.split(".")[0]] = (
                        a.name if a.asname else a.name.split(".")[0]
                    )
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                for a in node.names:
                    if a.name == "*":
                        continue
                    self.aliases[a.asname or a.name] = f"{node.module}.{a.name}"

    def _collect_defs(self) -> None:
        for node in self.tree.body:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self.defs[node.name] = node
        # simple name aliases are collected module-WIDE (scripts pick
        # their ask/tell implementations inside main()); first binding wins
        for node in ast.walk(self.tree):
            if isinstance(node, ast.Assign):
                # `tell = pgpe_tell` / `ask, tell = pgpe_ask, pgpe_tell` /
                # chained `a = b = pgpe_tell`
                for target in node.targets:
                    if (
                        isinstance(target, ast.Tuple)
                        and isinstance(node.value, ast.Tuple)
                        and len(target.elts) == len(node.value.elts)
                    ):
                        pairs = zip(target.elts, node.value.elts)
                    else:
                        pairs = [(target, node.value)]
                    for tgt, val in pairs:
                        if isinstance(tgt, ast.Name) and isinstance(val, ast.Name):
                            self.name_aliases.setdefault(tgt.id, val.id)

    def canon(self, node: ast.AST) -> Optional[str]:
        """Canonical dotted name of a Name/Attribute chain, with the leading
        segment expanded through this module's import aliases
        (``F.relu`` -> ``torch.nn.functional.relu``)."""
        name = dotted_name(node)
        if name is None:
            return None
        head, _, rest = name.partition(".")
        expanded = self.aliases.get(head, head)
        return f"{expanded}.{rest}" if rest else expanded

    def enclosing_function(self, node: ast.AST) -> Optional[ast.AST]:
        cur = getattr(node, "_gl_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                return cur
            cur = getattr(cur, "_gl_parent", None)
        return None

    def symbol_for(self, node: ast.AST) -> str:
        names = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                names.append(cur.name)
            elif isinstance(cur, ast.Lambda):
                names.append("<lambda>")
            cur = getattr(cur, "_gl_parent", None)
        return ".".join(reversed(names)) if names else "<module>"

    def enclosing_loops(self, node: ast.AST) -> List[ast.AST]:
        """Loops strictly containing ``node``, innermost-first, stopping at
        the enclosing function boundary."""
        loops = []
        cur = getattr(node, "_gl_parent", None)
        while cur is not None:
            if isinstance(cur, (ast.For, ast.While)):
                loops.append(cur)
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
                break
            cur = getattr(cur, "_gl_parent", None)
        return loops

    def finding(self, checker: str, node: ast.AST, message: str, detail: str) -> Finding:
        return Finding(
            checker=checker,
            path=self.path,
            line=getattr(node, "lineno", 0),
            symbol=self.symbol_for(node),
            message=message,
            detail=detail,
        )


@dataclass
class ProjectInfo:
    modules: List[ModuleInfo] = field(default_factory=list)
    #: module-level function name -> first positional parameter name
    func_first_param: Dict[str, str] = field(default_factory=dict)
    #: module-level function name -> body contains torch operations
    func_uses_torch: Dict[str, bool] = field(default_factory=dict)

    @classmethod
    def build(cls, modules: Iterable[ModuleInfo]) -> "ProjectInfo":
        project = cls(modules=list(modules))
        for mod in project.modules:
            project._collect_symbols(mod)
        return project

    def _collect_symbols(self, mod: ModuleInfo) -> None:
        for name, node in mod.defs.items():
            args = node.args
            params = list(args.posonlyargs) + list(args.args)
            if params and params[0].arg not in ("self", "cls"):
                self.func_first_param.setdefault(name, params[0].arg)
            for sub in ast.walk(node):
                canon = mod.canon(sub) if isinstance(sub, (ast.Name, ast.Attribute)) else None
                if canon and (canon == "torch" or canon.startswith("torch.")):
                    self.func_uses_torch[name] = True
                    break


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def repo_root() -> Path:
    """The repository root, assuming the canonical layout
    ``<root>/evotorch_tpu_torch/analysis/graftlint.py``."""
    return Path(__file__).resolve().parents[2]


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


#: the port's scripts (the other files of ``scripts/`` drive the JAX package)
PORT_SCRIPTS = ("packing_width.py", "shape_rounding.py")


def default_targets(root: Optional[Path] = None) -> List[Path]:
    """The gated lint surface: the port's package, its smoke test on the
    card and its scripts."""
    root = Path(root) if root is not None else repo_root()
    targets = [root / "evotorch_tpu_torch", root / "chip_smoke.py"]
    targets += [root / "scripts" / name for name in PORT_SCRIPTS]
    return [t for t in targets if t.exists()]


def _iter_py_files(targets: Iterable[Path]) -> Iterable[Path]:
    for target in targets:
        target = Path(target)
        if target.is_dir():
            for p in sorted(target.rglob("*.py")):
                if "__pycache__" not in p.parts:
                    yield p
        elif target.suffix == ".py":
            yield target


def lint_sources(
    sources: Dict[str, str], *, checkers: Optional[Sequence[str]] = None
) -> List[Finding]:
    """Lint in-memory sources ``{relpath: source}`` — the unit-test entry
    point (the file runner below funnels through this)."""
    from . import checkers as checker_mod

    modules = []
    findings: List[Finding] = []
    allows_by_path: Dict[str, Dict[int, set]] = {}
    for path, src in sources.items():
        allows, allow_problems = scoped_allows(path, src)
        allows_by_path[path] = allows
        findings.extend(allow_problems)
        try:
            modules.append(ModuleInfo.parse(path, src))
        except SyntaxError as e:
            findings.append(
                Finding(
                    checker="parse",
                    path=path,
                    line=e.lineno or 0,
                    symbol="<module>",
                    message=f"syntax error: {e.msg}",
                    detail="syntax-error",
                )
            )
    project = ProjectInfo.build(modules)
    for mod in project.modules:
        for name, check in checker_mod.CHECKERS.items():
            if checkers is not None and name not in checkers:
                continue
            findings.extend(check(mod, project))
    findings = _apply_scoped_allows(findings, allows_by_path)
    findings.sort(key=lambda f: (f.path, f.line, f.checker))
    return findings


def run_lint(
    targets: Optional[Sequence[Path]] = None,
    *,
    root: Optional[Path] = None,
    checkers: Optional[Sequence[str]] = None,
) -> List[Finding]:
    root = Path(root) if root is not None else repo_root()
    paths = list(targets) if targets else default_targets(root)
    sources: Dict[str, str] = {}
    for p in _iter_py_files(paths):
        try:
            rel = p.resolve().relative_to(root.resolve()).as_posix()
        except ValueError:
            rel = p.as_posix()
        sources[rel] = p.read_text()
    return lint_sources(sources, checkers=checkers)
