"""Contract lint: repository rules over the port's Python source
(``src/repro_torch``), the port of ``repro.analysis.lint``.

Stdlib ``ast`` only: it imports neither torch nor anything of the port,
so it runs before any install.  Each rule is a bug class that recurred
in the reference's history:

``IMPACT001``
    Bare ``assert`` on a runtime serving path (``src/repro_torch/serve/``
    or ``impact/runtime.py``).  ``python -O`` strips asserts, so a guard
    written as one silently vanishes in optimized deployments.  Raise a
    real exception.

``IMPACT002``
    Direct ``time.time()`` / ``time.monotonic()`` where the engine's
    injectable clock is in scope (the enclosing function takes a
    ``clock`` argument or references ``.clock``, or the enclosing class
    carries one).  A hard-coded wall clock next to an injected one
    breaks frozen-clock tests and skews the latency ledger.

``IMPACT003``
    Energy-bill arithmetic on the per-lane energy arrays
    (``e_clause_lanes`` / ``e_class_lanes``) without an f64 cast before
    summation.  Bills accumulate ~1e-11 J terms over many sweeps; in
    f32 the partial sums quantize and tenant bills drift from the batch
    meter.  A cast is ``np.float64`` or torch's ``.double()``,
    ``.to(torch.float64)`` or ``dtype=torch.float64``.

``IMPACT004``
    Backend registry conformance: every class handed to
    ``register_backend`` must implement or inherit the full primitive
    contract of the in-file ``Backend`` base (``kernels/backends.py``:
    ``fused_impact``, ``*_metered``, ``*_packed``, the staged
    compositions) with matching signatures — positional
    parameter names equal, keyword-only names a superset.  A near-miss
    signature turns into a ``TypeError`` at serve time; this catches it
    at lint time.

``IMPACT005``
    The reference's deprecated per-call shim kwargs (``meter_energy=``
    anywhere; ``impl=`` / ``mesh=`` / ``meter=`` on ``predict`` /
    ``infer_step`` / ``infer_with_report`` / ``IMPACTEngine`` calls).
    The port left the shims out on purpose, so no file is exempt: none
    may come back.

Waivers are per-line and auditable: append ``# lint: waive IMPACTnnn``
(optionally with a trailing reason) to the offending line or the line
directly above it.  Waived findings are returned with ``waived=True``
so a caller can count them; they never fail the gate.
"""
from __future__ import annotations

import ast
import dataclasses
import pathlib
import re

#: rule id -> one-line description (the README table is generated from
#: the same text).
RULES: dict[str, str] = {
    "IMPACT001": "bare `assert` on a runtime serving path (stripped "
                 "under python -O) — raise a real exception",
    "IMPACT002": "direct time.time()/time.monotonic() where the "
                 "injectable clock is in scope",
    "IMPACT003": "energy-lane arithmetic without an f64 cast before "
                 "summation",
    "IMPACT004": "register_backend class does not conform to the "
                 "Backend primitive contract",
    "IMPACT005": "deprecated per-call shim kwarg outside the shims",
}

#: IMPACT001/002/003 apply on the runtime serving paths only.
RUNTIME_SCOPE_PREFIXES = ("src/repro_torch/serve/",)
RUNTIME_SCOPE_FILES = ("src/repro_torch/impact/runtime.py",)

#: IMPACT005 exempts the modules that define deprecation shims: the port
#: has none.
SHIM_FILES: tuple[str, ...] = ()

_WAIVER_RE = re.compile(r"#\s*lint:\s*waive\s+(IMPACT\d{3})\b")

_LANE_NAMES = frozenset({"e_clause_lanes", "e_class_lanes"})
_DEPRECATED_ANYWHERE = frozenset({"meter_energy"})
_DEPRECATED_TARGETED = frozenset({"impl", "mesh", "meter"})
_SHIMMED_CALLEES = frozenset({"predict", "infer_step", "infer_with_report",
                              "IMPACTEngine"})


@dataclasses.dataclass(frozen=True)
class LintFinding:
    rule: str
    path: str
    line: int
    message: str
    waived: bool = False

    def __str__(self) -> str:
        tag = " (waived)" if self.waived else ""
        return f"{self.path}:{self.line}: {self.rule}{tag} {self.message}"


def _norm(path: str) -> str:
    return path.replace("\\", "/")


def in_runtime_scope(path: str) -> bool:
    p = _norm(path)
    return (any(p.startswith(pre) for pre in RUNTIME_SCOPE_PREFIXES)
            or p in RUNTIME_SCOPE_FILES)


def _parse_waivers(text: str) -> dict[int, set[str]]:
    waivers: dict[int, set[str]] = {}
    for i, line in enumerate(text.splitlines(), start=1):
        for m in _WAIVER_RE.finditer(line):
            waivers.setdefault(i, set()).add(m.group(1))
    return waivers


def _callee_name(func: ast.expr) -> str | None:
    if isinstance(func, ast.Attribute):
        return func.attr
    if isinstance(func, ast.Name):
        return func.id
    return None


def _walk_scoped(tree: ast.Module):
    """Yield ``(node, enclosing_function, enclosing_class)`` for every
    node, where the enclosures are the nearest FunctionDef / ClassDef."""
    def rec(node, fn, cls):
        for child in ast.iter_child_nodes(node):
            c_fn, c_cls = fn, cls
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                c_fn = child
            elif isinstance(child, ast.ClassDef):
                c_cls, c_fn = child, None
            yield child, c_fn, c_cls
            yield from rec(child, c_fn, c_cls)
    yield from rec(tree, None, None)


# -- IMPACT001 ---------------------------------------------------------------

def _rule_impact001(tree, path):
    if not in_runtime_scope(path):
        return []
    return [LintFinding(
        "IMPACT001", path, node.lineno,
        "bare assert on a serving path — python -O strips it; raise "
        "ValueError/RuntimeError instead")
        for node, _fn, _cls in _walk_scoped(tree)
        if isinstance(node, ast.Assert)]


# -- IMPACT002 ---------------------------------------------------------------

def _is_wall_clock_call(node) -> bool:
    return (isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr in ("time", "monotonic")
            and isinstance(node.func.value, ast.Name)
            and node.func.value.id == "time")


def _mentions_clock(node) -> bool:
    return any(isinstance(n, ast.Attribute) and n.attr == "clock"
               for n in ast.walk(node))


def _fn_has_clock(fn) -> bool:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    return "clock" in names or _mentions_clock(fn)


def _rule_impact002(tree, path):
    if not in_runtime_scope(path):
        return []
    clocked_classes = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and _mentions_clock(node):
            clocked_classes.add(node)
    findings = []
    for node, fn, cls in _walk_scoped(tree):
        if not _is_wall_clock_call(node) or fn is None:
            continue
        if _fn_has_clock(fn) or (cls is not None and cls in clocked_classes):
            findings.append(LintFinding(
                "IMPACT002", path, node.lineno,
                f"time.{node.func.attr}() bypasses the injectable clock "
                f"in scope here — use the injected clock"))
    return findings


# -- IMPACT003 ---------------------------------------------------------------

def _has_f64(node) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in ("float64", "double"):
            return True
        if isinstance(n, ast.Name) and n.id == "float64":
            return True
        if isinstance(n, ast.Constant) and n.value == "float64":
            return True
    return False


def _lane_attr_refs(node):
    for n in ast.walk(node):
        if isinstance(n, ast.Attribute) and n.attr in _LANE_NAMES:
            yield n
        elif isinstance(n, ast.Name) and n.id in _LANE_NAMES:
            yield n


def _is_sum_site(node) -> bool:
    if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
        return True
    if isinstance(node, ast.Call):
        name = _callee_name(node.func)
        return name == "sum"
    return False


def _rule_impact003(tree, path):
    if not in_runtime_scope(path):
        return []
    findings = []
    seen: set[int] = set()
    for fn in (n for n in ast.walk(tree)
               if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))):
        tainted: set[str] = set()
        blessed: set[str] = set()
        for stmt in ast.walk(fn):
            if (isinstance(stmt, ast.Assign) and len(stmt.targets) == 1
                    and isinstance(stmt.targets[0], ast.Name)
                    and any(True for _ in _lane_attr_refs(stmt.value))):
                tainted.add(stmt.targets[0].id)
                if _has_f64(stmt.value):
                    blessed.add(stmt.targets[0].id)
        dirty_names = tainted - blessed
        for site in ast.walk(fn):
            if not _is_sum_site(site) or site.lineno in seen:
                continue
            direct = any(isinstance(r, ast.Attribute)
                         for r in _lane_attr_refs(site))
            via_name = any(isinstance(n, ast.Name) and n.id in dirty_names
                           for n in ast.walk(site))
            if (direct or via_name) and not _has_f64(site):
                seen.add(site.lineno)
                findings.append(LintFinding(
                    "IMPACT003", path, site.lineno,
                    "energy-lane arithmetic without an f64 cast — bill "
                    "sums must go through np.float64 (or torch.float64) "
                    "before accumulation"))
    return findings


# -- IMPACT004 ---------------------------------------------------------------

def _method_defs(cls) -> dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}


def _pos_names(fn) -> list[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def _kwonly_names(fn) -> set[str]:
    return {a.arg for a in fn.args.kwonlyargs}


def _mro_chain(cls, classes):
    """In-file MRO approximation: the class, then each resolvable base
    depth-first.  Returns (chain, fully_resolved)."""
    chain, resolved = [], True
    stack = [cls]
    while stack:
        c = stack.pop(0)
        if c in chain:
            continue
        chain.append(c)
        for b in c.bases:
            if isinstance(b, ast.Name) and b.id in classes:
                stack.append(classes[b.id])
            else:
                resolved = False
    return chain, resolved


def _rule_impact004(tree, path):
    classes = {n.name: n for n in ast.walk(tree)
               if isinstance(n, ast.ClassDef)}
    base = classes.get("Backend")
    if base is None:
        return []
    contract = {name: fn for name, fn in _method_defs(base).items()
                if not name.startswith("_")}
    findings = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call)
                and _callee_name(node.func) == "register_backend"
                and node.args):
            continue
        arg = node.args[0]
        cls_name = None
        if isinstance(arg, ast.Call):
            cls_name = _callee_name(arg.func)
        elif isinstance(arg, ast.Name):
            cls_name = arg.id
        cls = classes.get(cls_name)
        if cls is None or cls is base:
            continue
        chain, resolved = _mro_chain(cls, classes)
        methods: dict[str, ast.FunctionDef] = {}
        for c in chain:
            for name, fn in _method_defs(c).items():
                methods.setdefault(name, fn)
        if resolved and base in chain:
            missing = sorted(set(contract) - set(methods))
        elif resolved:
            # chain never reaches Backend: nothing is inherited.
            missing = sorted(set(contract) - set(methods))
        else:
            missing = []      # unresolvable import-time base: can't prove
        for name in missing:
            findings.append(LintFinding(
                "IMPACT004", path, node.lineno,
                f"registered backend {cls_name!r} is missing primitive "
                f"{name!r} from the Backend contract"))
        # Signature conformance of every in-file override.
        for c in chain:
            if c is base:
                continue
            for name, fn in _method_defs(c).items():
                ref = contract.get(name)
                if ref is None:
                    continue
                if _pos_names(fn) != _pos_names(ref):
                    findings.append(LintFinding(
                        "IMPACT004", path, fn.lineno,
                        f"{c.name}.{name} positional signature "
                        f"{_pos_names(fn)} != Backend contract "
                        f"{_pos_names(ref)}"))
                elif not _kwonly_names(fn) >= _kwonly_names(ref):
                    lost = sorted(_kwonly_names(ref) - _kwonly_names(fn))
                    findings.append(LintFinding(
                        "IMPACT004", path, fn.lineno,
                        f"{c.name}.{name} drops keyword-only params "
                        f"{lost} from the Backend contract"))
    # One finding per (line, message).
    uniq = {(f.line, f.message): f for f in findings}
    return list(uniq.values())


# -- IMPACT005 ---------------------------------------------------------------

def _rule_impact005(tree, path):
    if _norm(path) in SHIM_FILES:
        return []
    findings = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _callee_name(node.func)
        for kw in node.keywords:
            if kw.arg in _DEPRECATED_ANYWHERE:
                findings.append(LintFinding(
                    "IMPACT005", path, node.lineno,
                    f"deprecated shim kwarg {kw.arg}= — encode it in a "
                    f"RuntimeSpec instead"))
            elif (kw.arg in _DEPRECATED_TARGETED
                    and callee in _SHIMMED_CALLEES):
                findings.append(LintFinding(
                    "IMPACT005", path, node.lineno,
                    f"deprecated shim kwarg {kw.arg}= on {callee}() — "
                    f"encode it in a RuntimeSpec instead"))
    return findings


_ALL_RULES = (_rule_impact001, _rule_impact002, _rule_impact003,
              _rule_impact004, _rule_impact005)


# -- linting files and trees ----------------------------------------------

def lint_source(text: str, path: str) -> list[LintFinding]:
    """Lint one file's source.  ``path`` must be repo-relative (posix)
    — the rules scope by it.  Waived findings come back with
    ``waived=True``; syntax errors surface as an un-waivable finding."""
    try:
        tree = ast.parse(text)
    except SyntaxError as e:
        return [LintFinding("SYNTAX", path, e.lineno or 0,
                            f"could not parse: {e.msg}")]
    waivers = _parse_waivers(text)
    findings: list[LintFinding] = []
    for rule in _ALL_RULES:
        for f in rule(tree, _norm(path)):
            lines = (f.line, f.line - 1)
            waived = any(f.rule in waivers.get(ln, ()) for ln in lines)
            findings.append(dataclasses.replace(f, waived=waived))
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def iter_target_files(root) -> list[pathlib.Path]:
    root = pathlib.Path(root)
    return sorted((root / "src" / "repro_torch").rglob("*.py"))


def lint_tree(root) -> list[LintFinding]:
    """Lint every ``src/repro_torch`` Python file under ``root`` (the root
    of a checkout)."""
    root = pathlib.Path(root)
    findings: list[LintFinding] = []
    for p in iter_target_files(root):
        rel = p.relative_to(root).as_posix()
        findings.extend(lint_source(p.read_text(), rel))
    return findings
