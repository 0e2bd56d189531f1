"""AST lint pass over ``dmr.App`` user code and ``Policy`` implementations
(port of ``repro/analysis/lint.py``).

Each rule encodes a malleability-contract bug class:

======= ===============================================================
code    rule
======= ===============================================================
DMR101  **stale-mesh-closure** — a step factory (``make_step``, an
        ``@app.step`` function, or ``App(step=...)``) that reads a
        callable or value built *once, at module level, for one mesh*:
        a CUDA graph (``torch.cuda.CUDAGraph()`` captured under
        ``torch.cuda.graph``, or ``torch.cuda.make_graphed_callables``),
        whose kernels, shapes and pointers are fixed at capture; a
        TorchScript function (``torch.jit.script`` resolves the globals
        it reads to constants, ``torch.jit.trace`` records one run's
        operations with every Python value baked in); or a
        ``make_job_mesh(...)`` / ``Placement(...)`` value read instead of
        the factory's ``mesh`` argument.  The runner caches one step
        closure per size (``dmr/runner.py``); such a callable defeats
        that cache and replays the first mesh after ``reconfig``, so
        build it inside the factory, per mesh.  ``torch.compile`` is not
        flagged: Dynamo guards every shape, Python number and global its
        graph reads and recompiles when one changes, so a compiled
        function cannot replay a stale mesh.
DMR102  **stateful-stateless-policy** — a ``Policy`` class that
        declares ``decide_stateless = True`` (explicitly, or by
        inheriting ``BasePolicy`` without overriding it) but writes
        ``self.<attr>`` inside ``decide()``/``priority_key()``.  The
        event engines cache and reorder stateless decisions
        (``PendingMins`` collapsing, epoch memoization), so hidden
        state desynchronizes the engines.
DMR103  **unmatched-pattern-path** — a redistribution-``patterns`` dict
        whose path prefix can never match the state tree built by the
        module's ``init``/``shardings`` functions; the pattern would
        silently fall back to the default for every leaf.
DMR105  **resize-in-inhibitor-window** — a scripted RMS schedule whose
        consecutive decision steps are closer than the module's
        ``sched_iterations`` inhibitor window: the later decision
        cannot fire at its requested step (it is deferred to the next
        query the §3.2 guard lets through).
DMR106  **device-list-mutation-outside-contract** — code that mutates a
        ``.devices`` list (``append``/``extend``/slice-assign/rebind/
        ``del``) outside the :class:`repro_torch.dmr.MalleableTenant`
        contract methods (``grant_devices``/``release_devices``/
        ``shutdown``) or a constructor.  Devices that enter or leave a
        tenant without going through the contract are invisible to the
        cluster's pool accounting and to the trail auditor — the exact
        double-grant / leaked-device class the contract exists to
        prevent.
======= ===============================================================

The JAX package's DMR104 (imports of its deprecated ``repro.core`` shims)
has no counterpart: the port has no such shims, so ``RULES`` holds five
rules.

Suppress a finding with ``# dmr: ignore[DMR1xx]`` on the offending line.
Entry points: :func:`lint_source` (one module), :func:`lint_paths`
(files/directories — the ``python -m repro_torch.analysis lint`` CLI).
"""
from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Set

__all__ = ["LintFinding", "lint_source", "lint_paths", "RULES"]


@dataclasses.dataclass(frozen=True)
class LintFinding:
    path: str
    line: int
    code: str
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: {self.code} {self.message}"


# ----------------------------------------------------------------------
# shared AST helpers
# ----------------------------------------------------------------------

def _dotted(node: ast.AST) -> str:
    """'torch.jit.script' for Name/Attribute chains; '' for anything else."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return ""


#: calls whose result replays what it captured, by the tail of their dotted
#: name (``torch.jit.script``, ``jit.script``), with what each one fixes
_CAPTURES = {
    "jit.script": "a TorchScript function compiled once (its globals "
                  "resolved to constants)",
    "jit.trace": "a TorchScript trace of one run (its Python values baked "
                 "in)",
    "jit.trace_module": "a TorchScript trace of one run (its Python values "
                        "baked in)",
    "cuda.CUDAGraph": "a CUDA graph captured once (its kernels, shapes and "
                      "pointers fixed)",
    "cuda.make_graphed_callables": "a CUDA graph captured once (its "
                                   "kernels, shapes and pointers fixed)",
}
#: calls that build a value for one mesh, by the last part of their name
_MESH_VALUES = {"make_job_mesh": "a job mesh built once",
                "Placement": "a placement built once, on one mesh"}


def _capture_kind(name: str) -> Optional[str]:
    """What a call named ``name`` captures once, or None."""
    for tail, kind in _CAPTURES.items():
        if name == tail or name.endswith("." + tail):
            return kind
    return _MESH_VALUES.get(name.split(".")[-1]) if name else None


def _call_kind(node: ast.AST) -> Optional[str]:
    """``torch.jit.script(...)`` / ``Placement(...)`` /
    ``partial(torch.jit.trace, ...)``: what the call captures, or None."""
    if not isinstance(node, ast.Call):
        return None
    name = _dotted(node.func)
    if name.endswith("partial") and node.args:
        return _capture_kind(_dotted(node.args[0]))
    return _capture_kind(name)


def _decorator_kind(fn: ast.AST) -> Optional[str]:
    """``@torch.jit.script`` (bare or called): what it captures, or None."""
    for dec in getattr(fn, "decorator_list", []):
        kind = _capture_kind(_dotted(dec)) or _call_kind(dec)
        if kind is not None:
            return kind
    return None


def _local_names(fn: ast.AST) -> Set[str]:
    """Names bound inside a function body: params, assignments, defs."""
    names: Set[str] = set()
    args = fn.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        names.add(a.arg)
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    for node in ast.walk(fn):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)) and node is not fn:
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for t in targets:
                for sub in ast.walk(t):
                    if isinstance(sub, ast.Name):
                        names.add(sub.id)
        elif isinstance(node, ast.comprehension):
            for sub in ast.walk(node.target):
                if isinstance(sub, ast.Name):
                    names.add(sub.id)
    return names


def _ignored_lines(source: str) -> Dict[int, Set[str]]:
    """``# dmr: ignore[DMR101]`` / ``# dmr: ignore`` suppressions."""
    out: Dict[int, Set[str]] = {}
    pat = re.compile(r"#\s*dmr:\s*ignore(?:\[([A-Z0-9, ]+)\])?")
    for i, line in enumerate(source.splitlines(), start=1):
        m = pat.search(line)
        if m:
            codes = {c.strip() for c in (m.group(1) or "").split(",")
                     if c.strip()}
            out[i] = codes or {"*"}
    return out


# ----------------------------------------------------------------------
# DMR101 — stale-mesh-closure
# ----------------------------------------------------------------------

def _step_factories(tree: ast.Module) -> List[ast.AST]:
    """Functions that are step factories: named ``make_step``, decorated
    with ``@<app>.step``, or passed as ``step=`` to an ``App(...)``
    constructor (def or lambda)."""
    factories: List[ast.AST] = []
    module_defs = {n.name: n for n in ast.walk(tree)
                   if isinstance(n, ast.FunctionDef)}
    seen: Set[int] = set()

    def add(node: ast.AST) -> None:
        if id(node) not in seen:
            seen.add(id(node))
            factories.append(node)

    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef):
            if node.name == "make_step":
                add(node)
            for dec in node.decorator_list:
                if isinstance(dec, ast.Attribute) and dec.attr == "step":
                    add(node)
        elif isinstance(node, ast.Call):
            callee = _dotted(node.func)
            if callee.split(".")[-1] != "App":
                continue
            for kw in node.keywords:
                if kw.arg != "step":
                    continue
                if isinstance(kw.value, ast.Lambda):
                    add(kw.value)
                elif isinstance(kw.value, ast.Name) and \
                        kw.value.id in module_defs:
                    add(module_defs[kw.value.id])
    return factories


def _module_captures(tree: ast.Module) -> Dict[str, str]:
    """Names bound at module level to something captured once, with what
    it is: decorated defs, assignments from a capturing call, and the graph
    and outputs of a module-level ``with torch.cuda.graph(g):`` capture."""
    captured: Dict[str, str] = {}

    def bind(targets, kind: str) -> None:
        for t in targets:
            for sub in ast.walk(t):
                if isinstance(sub, ast.Name):
                    captured[sub.id] = kind

    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            kind = _decorator_kind(node)
            if kind is not None:
                captured[node.name] = kind
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            kind = _call_kind(node.value)
            if kind is not None:
                bind(node.targets if isinstance(node, ast.Assign)
                     else [node.target], kind)
        elif isinstance(node, ast.With):
            graphs = [item.context_expr.args[0] for item in node.items
                      if isinstance(item.context_expr, ast.Call) and
                      _dotted(item.context_expr.func).endswith("cuda.graph")
                      and item.context_expr.args]
            if graphs:
                kind = _CAPTURES["cuda.CUDAGraph"]
                bind(graphs, kind)
                for stmt in node.body:
                    if isinstance(stmt, (ast.Assign, ast.AnnAssign)):
                        bind(stmt.targets if isinstance(stmt, ast.Assign)
                             else [stmt.target], kind)
    return captured


def check_stale_mesh_closure(tree: ast.Module, path: str,
                             source: str) -> List[LintFinding]:
    captured = _module_captures(tree)
    if not captured:
        return []
    findings = []
    for fac in _step_factories(tree):
        local = _local_names(fac) if isinstance(
            fac, (ast.FunctionDef, ast.AsyncFunctionDef)) else {
                a.arg for a in fac.args.args}
        body = fac.body if isinstance(fac.body, list) else [fac.body]
        for stmt in body:
            for node in ast.walk(stmt):
                if isinstance(node, ast.Name) and \
                        isinstance(node.ctx, ast.Load) and \
                        node.id in captured and node.id not in local:
                    findings.append(LintFinding(
                        path, node.lineno, "DMR101",
                        f"step factory uses module-level '{node.id}', "
                        f"{captured[node.id]}: the runner caches one step "
                        f"closure per size, and this one replays the mesh "
                        f"it was built for after reconfig — build it "
                        f"inside the factory, per mesh"))
    return findings


# ----------------------------------------------------------------------
# DMR102 — stateful stateless policy
# ----------------------------------------------------------------------

_STATELESS_BASES = {"BasePolicy", "Algorithm2Policy", "EnergyAwarePolicy",
                    "ThroughputGreedyPolicy"}


def check_stateful_stateless_policy(tree: ast.Module, path: str,
                                    source: str) -> List[LintFinding]:
    findings = []
    for cls in ast.walk(tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        stateless: Optional[bool] = None
        for node in cls.body:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and \
                            t.id == "decide_stateless" and \
                            isinstance(node.value, ast.Constant):
                        stateless = bool(node.value.value)
        if stateless is None:
            bases = {_dotted(b).split(".")[-1] for b in cls.bases}
            if bases & _STATELESS_BASES:
                stateless = True            # BasePolicy defaults to True
        has_decide = any(isinstance(n, ast.FunctionDef) and
                         n.name == "decide" for n in cls.body)
        if not stateless or not has_decide:
            continue
        for fn in cls.body:
            if not isinstance(fn, ast.FunctionDef) or \
                    fn.name not in ("decide", "priority_key"):
                continue
            for node in ast.walk(fn):
                targets = []
                if isinstance(node, ast.Assign):
                    targets = node.targets
                elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                    targets = [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        findings.append(LintFinding(
                            path, node.lineno, "DMR102",
                            f"policy '{cls.name}' declares "
                            f"decide_stateless=True but {fn.name}() "
                            f"writes self.{t.attr} — the event engines "
                            f"collapse and memoize stateless decisions, "
                            f"so hidden state desynchronizes them; set "
                            f"decide_stateless = False or move the "
                            f"state into configure()"))
    return findings


# ----------------------------------------------------------------------
# DMR103 — unmatched redistribution-pattern path
# ----------------------------------------------------------------------

def _state_tree_keys(tree: ast.Module) -> Optional[Set[str]]:
    """Top-level state keys, from dict literals returned by
    init/shardings functions (``init_state``/``state_shardings``/
    ``@app.init``/``@app.shardings``/plain ``init``/``shardings``).
    None when no such dict literal exists (check cannot run)."""
    keys: Set[str] = set()
    found = False
    for fn in ast.walk(tree):
        if not isinstance(fn, ast.FunctionDef):
            continue
        is_state_fn = fn.name in ("init", "init_state", "shardings",
                                  "state_shardings")
        for dec in fn.decorator_list:
            if isinstance(dec, ast.Attribute) and \
                    dec.attr in ("init", "shardings"):
                is_state_fn = True
        if not is_state_fn:
            continue
        for node in ast.walk(fn):
            if isinstance(node, ast.Return) and \
                    isinstance(node.value, ast.Dict):
                consts = [k for k in node.value.keys
                          if isinstance(k, ast.Constant) and
                          isinstance(k.value, str)]
                if consts and len(consts) == len(node.value.keys):
                    found = True
                    keys.update(k.value for k in consts)
    return keys if found else None


def check_unmatched_pattern_path(tree: ast.Module, path: str,
                                 source: str) -> List[LintFinding]:
    keys = _state_tree_keys(tree)
    if keys is None:
        return []
    findings = []
    pattern_dicts: List[ast.Dict] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Call):
            for kw in node.keywords:
                if kw.arg == "patterns" and isinstance(kw.value, ast.Dict):
                    pattern_dicts.append(kw.value)
        elif isinstance(node, ast.Assign) and \
                isinstance(node.value, ast.Dict):
            for t in node.targets:
                if isinstance(t, ast.Name) and \
                        t.id.lower() in ("patterns", "pattern_specs"):
                    pattern_dicts.append(node.value)
    for d in pattern_dicts:
        for k in d.keys:
            if not (isinstance(k, ast.Constant) and
                    isinstance(k.value, str)):
                continue
            prefix = k.value.split("/")[0]
            if prefix != "*" and prefix not in keys:
                findings.append(LintFinding(
                    path, k.lineno, "DMR103",
                    f"pattern path '{k.value}' can never match: the "
                    f"state tree's top-level keys are "
                    f"{sorted(keys)} — every leaf would silently fall "
                    f"back to the default pattern"))
    return findings


# ----------------------------------------------------------------------
# DMR105 — scripted resize inside the inhibitor window
# ----------------------------------------------------------------------

def _int_kw(call: ast.Call, name: str) -> Optional[int]:
    for kw in call.keywords:
        if kw.arg == name and isinstance(kw.value, ast.Constant) and \
                isinstance(kw.value.value, int):
            return kw.value.value
    return None


def check_resize_in_inhibitor_window(tree: ast.Module, path: str,
                                     source: str) -> List[LintFinding]:
    windows: List[int] = []
    schedules: List[ast.Dict] = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        callee = _dotted(node.func).split(".")[-1]
        if callee in ("set_parameters", "MalleabilityParams"):
            k = _int_kw(node, "sched_iterations")
            if k is not None and k > 1:
                windows.append(k)
        if callee in ("ScriptedRMS", "connect") and node.args and \
                isinstance(node.args[0], ast.Dict):
            schedules.append(node.args[0])
    # only check when the module pins exactly one inhibitor window —
    # with several, pairing schedules to windows is guesswork
    if len(set(windows)) != 1 or not schedules:
        return []
    window = windows[0]
    findings = []
    for d in schedules:
        steps = sorted(
            (k.value, k.lineno) for k in d.keys
            if isinstance(k, ast.Constant) and isinstance(k.value, int))
        for (a, _), (b, line) in zip(steps, steps[1:]):
            if b - a < window:
                findings.append(LintFinding(
                    path, line, "DMR105",
                    f"scripted decisions at steps {a} and {b} are "
                    f"closer than the sched_iterations={window} "
                    f"inhibitor window — the step-{b} decision cannot "
                    f"fire before step {a + window}"))
    return findings


# ----------------------------------------------------------------------
# DMR106 — device-list mutation outside the tenant contract
# ----------------------------------------------------------------------

_DEVICE_MUTATORS = {"append", "extend", "insert", "remove", "pop", "clear",
                    "sort", "reverse"}
# methods where .devices mutation IS the contract (or first construction)
_CONTRACT_METHODS = {"grant_devices", "release_devices", "shutdown",
                     "handle_failure", "__init__"}


def _is_devices_attr(node: ast.AST) -> bool:
    return isinstance(node, ast.Attribute) and node.attr == "devices"


def check_device_list_mutation(tree: ast.Module, path: str,
                               source: str) -> List[LintFinding]:
    findings = []

    def flag(node: ast.AST, what: str) -> None:
        findings.append(LintFinding(
            path, node.lineno, "DMR106",
            f"{what} mutates a .devices list outside the MalleableTenant "
            f"contract — route it through grant_devices()/"
            f"release_devices()/shutdown() so the pool accounting and "
            f"trail auditor see the transfer"))

    def visit(node: ast.AST, fn: Optional[str]) -> None:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            fn = node.name
        exempt = fn in _CONTRACT_METHODS
        if not exempt:
            if isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _DEVICE_MUTATORS and \
                    _is_devices_attr(node.func.value):
                flag(node, f"'.devices.{node.func.attr}(...)'")
            elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if _is_devices_attr(base):
                        what = "subscript assignment to '.devices'" \
                            if isinstance(t, ast.Subscript) \
                            else "rebinding '.devices'"
                        flag(node, what)
            elif isinstance(node, ast.Delete):
                for t in node.targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if _is_devices_attr(base):
                        flag(node, "'del' on '.devices'")
        for child in ast.iter_child_nodes(node):
            visit(child, fn)

    visit(tree, None)
    return findings


# ----------------------------------------------------------------------
# entry points
# ----------------------------------------------------------------------

RULES = [
    ("DMR101", check_stale_mesh_closure),
    ("DMR102", check_stateful_stateless_policy),
    ("DMR103", check_unmatched_pattern_path),
    ("DMR105", check_resize_in_inhibitor_window),
    ("DMR106", check_device_list_mutation),
]


def lint_source(source: str, path: str = "<string>",
                rules: Optional[Sequence[str]] = None) -> List[LintFinding]:
    """Lint one module's source; returns findings sorted by line."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [LintFinding(path, exc.lineno or 0, "DMR100",
                            f"syntax error: {exc.msg}")]
    ignored = _ignored_lines(source)
    findings: List[LintFinding] = []
    for code, rule in RULES:
        if rules is not None and code not in rules:
            continue
        for f in rule(tree, path, source):
            codes = ignored.get(f.line, ())
            if "*" in codes or f.code in codes:
                continue
            findings.append(f)
    return sorted(findings, key=lambda f: (f.line, f.code))


def lint_paths(paths: Sequence[str],
               rules: Optional[Sequence[str]] = None) -> List[LintFinding]:
    """Lint ``.py`` files under the given files/directories."""
    files: List[str] = []
    for p in paths:
        if os.path.isdir(p):
            for root, dirs, names in os.walk(p):
                dirs[:] = sorted(d for d in dirs
                                 if not d.startswith((".", "__pycache__")))
                files.extend(os.path.join(root, n) for n in sorted(names)
                             if n.endswith(".py"))
        elif p.endswith(".py"):
            files.append(p)
    findings: List[LintFinding] = []
    for fp in files:
        with open(fp, encoding="utf-8") as fh:
            findings.extend(lint_source(fh.read(), fp, rules))
    return findings
