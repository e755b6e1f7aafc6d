"""Repo rules: AST lint over the library source itself.

The counterpart of `repro/analysis/repo_rules.py`, copied: the rules,
their scope and their opt-out markers are the JAX package's, run over
`src/repro_torch`.  `rules/unhashable-static` looks for `jax.jit` and
finds nothing in the port; it stays so that both packages hold one rule
set.

The runtime analyzers check what a program IS; these rules check what
the source says, catching patterns that only bite later:

  rules/bare-assert        `assert` in library code — stripped under
                           `python -O`, so the invariant silently stops
                           being checked (use repro_torch.errors instead)
  rules/mutable-default    mutable default argument (shared across
                           calls; classic aliasing bug)
  rules/unhashable-static  a jit static argument with a mutable default
                           — tracing would crash (or worse, cache on
                           object identity) the first time the default
                           is used
  rules/swallowed-exception  in the serving/maintenance/api packages, a
                           broad handler (`except:` / `except Exception`)
                           whose body neither re-raises nor calls
                           anything — the fault-tolerant serving core
                           must degrade, roll back, or at least record
                           a fault; silently eating one hides exactly
                           the failures the degradation ladder exists
                           to surface (opt-out: ``# lint: allow-swallow``
                           on the except line)
  rules/unbounded-queue    in the serve package, container growth with
                           no visible bound: a `deque()` without
                           `maxlen`, or `.append/.appendleft/.extend`
                           on persistent state (an attribute) whose
                           module never trims it (`del x[...]`), slices
                           it back, or length-guards it — a serving
                           process runs indefinitely, so an unbounded
                           queue is a slow memory leak and an unbounded
                           latency backlog (opt-out:
                           ``# lint: allow-unbounded``)

Scope: the pipeline packages (`core`, `query`, `api`, `views`, `rdf`,
`serve`, `kernels`, `checkpoint`, `analysis`, the top-level modules).
The ML-substrate packages inherited from the seed (`models`, `launch`,
`train`, `configs`, `distributed`, `data`) are excluded — they run
under tracing where asserts act as shape guards — as are tests.  A
line-level opt-out exists: append ``# lint: allow-assert``.
"""
from __future__ import annotations

import ast
import os

from repro_torch.analysis.findings import Finding

EXCLUDED_DIRS = frozenset(
    {"models", "launch", "train", "configs", "distributed", "data",
     "tests", "__pycache__"})
ALLOW_MARKER = "lint: allow-assert"
SWALLOW_MARKER = "lint: allow-swallow"
UNBOUNDED_MARKER = "lint: allow-unbounded"
# packages where a silently-swallowed exception defeats fault tolerance
SWALLOW_SCOPE = frozenset({"serve", "maintenance", "api"})
# packages where an unbounded queue is a memory leak / latency backlog
QUEUE_SCOPE = frozenset({"serve"})
_GROW_METHODS = ("append", "appendleft", "extend")

_MUTABLE_CALLS = ("list", "dict", "set", "bytearray")


def _f(rule: str, message: str, location: str,
       severity: str = "error") -> Finding:
    return Finding("rules", rule, severity, message, location)


def _is_mutable_literal(node: ast.expr) -> bool:
    if isinstance(node, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) and isinstance(node.func, ast.Name):
        return node.func.id in _MUTABLE_CALLS
    return False


def _defaults_by_param(fn: ast.FunctionDef | ast.AsyncFunctionDef
                       ) -> dict[str, ast.expr]:
    """param name -> default expression (positional + kw-only)."""
    out: dict[str, ast.expr] = {}
    pos = fn.args.posonlyargs + fn.args.args
    for arg, default in zip(pos[len(pos) - len(fn.args.defaults):],
                            fn.args.defaults):
        out[arg.arg] = default
    for arg, default in zip(fn.args.kwonlyargs, fn.args.kw_defaults):
        if default is not None:
            out[arg.arg] = default
    return out


def _param_names(fn: ast.FunctionDef | ast.AsyncFunctionDef) -> list[str]:
    return [a.arg for a in fn.args.posonlyargs + fn.args.args]


def _is_jit_ref(node: ast.expr) -> bool:
    """`jax.jit`, `jit`, `pjit`, `jax.pmap` references."""
    if isinstance(node, ast.Name):
        return node.id in ("jit", "pjit", "pmap")
    if isinstance(node, ast.Attribute):
        return node.attr in ("jit", "pjit", "pmap")
    return False


def _static_params(call: ast.Call, fn: ast.FunctionDef | None
                   ) -> list[str] | None:
    """Parameter names a jit call marks static, or None if not a jit
    call with static arguments."""
    if not (_is_jit_ref(call.func)
            or (isinstance(call.func, ast.Attribute)
                and call.func.attr == "partial"
                and call.args and _is_jit_ref(call.args[0]))
            or (isinstance(call.func, ast.Name)
                and call.func.id == "partial"
                and call.args and _is_jit_ref(call.args[0]))):
        return None
    names: list[str] = []
    for kw in call.keywords:
        if kw.arg == "static_argnames":
            for elt in ast.walk(kw.value):
                if isinstance(elt, ast.Constant) and isinstance(elt.value,
                                                                str):
                    names.append(elt.value)
        elif kw.arg == "static_argnums" and fn is not None:
            params = _param_names(fn)
            for elt in ast.walk(kw.value):
                if isinstance(elt, ast.Constant) and isinstance(elt.value,
                                                                int):
                    if 0 <= elt.value < len(params):
                        names.append(params[elt.value])
    return names


def _catches_broad(handler: ast.ExceptHandler) -> bool:
    """`except:`, `except Exception`, `except BaseException` (possibly
    inside a tuple)."""
    if handler.type is None:
        return True
    for node in ast.walk(handler.type):
        if isinstance(node, ast.Name) \
                and node.id in ("Exception", "BaseException"):
            return True
        if isinstance(node, ast.Attribute) \
                and node.attr in ("Exception", "BaseException"):
            return True
    return False


def _swallows(handler: ast.ExceptHandler) -> bool:
    """True when the handler body neither re-raises nor calls anything
    (no rollback, no fault log, no fallback) — the failure vanishes."""
    for stmt in handler.body:
        for node in ast.walk(stmt):
            if isinstance(node, (ast.Raise, ast.Call)):
                return False
    return True


def _container_attr(node: ast.expr) -> str | None:
    """Name of the persistent attribute a container expression lives on,
    unwrapping subscripts: `self.log` -> "log", `self.produced[i]` ->
    "produced", `self.stats.faults` -> "faults".  None for plain local
    names (function-scoped lists are bounded by the call)."""
    while isinstance(node, ast.Subscript):
        node = node.value
    if isinstance(node, ast.Attribute):
        return node.attr
    return None


def _is_deque_call(node: ast.Call) -> bool:
    if isinstance(node.func, ast.Name):
        return node.func.id == "deque"
    if isinstance(node.func, ast.Attribute):
        return node.func.attr == "deque"
    return False


def _bounded_attrs(tree: ast.AST) -> set[str]:
    """Attributes the module visibly bounds: trimmed with `del x[...]`,
    reassigned through a slice of themselves, or length-guarded with
    `len(...)` anywhere (the guard is assumed to enforce a cap)."""
    bounded: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    attr = _container_attr(t)
                    if attr:
                        bounded.add(attr)
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                and node.func.id == "len" and node.args:
            attr = _container_attr(node.args[0])
            if attr:
                bounded.add(attr)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _container_attr(t) if isinstance(t, (ast.Subscript,
                                                            ast.Attribute)) \
                    else None
                if not attr:
                    continue
                if isinstance(node.value, ast.Subscript) \
                        and _container_attr(node.value) == attr:
                    bounded.add(attr)  # x = x[-n:] style self-trim
                if isinstance(node.value, ast.Call) \
                        and _is_deque_call(node.value) \
                        and any(kw.arg == "maxlen"
                                for kw in node.value.keywords):
                    bounded.add(attr)  # deque(maxlen=...) self-bounds
    return bounded


def _check_unbounded(tree: ast.AST, lines: list[str],
                     path: str) -> list[Finding]:
    out: list[Finding] = []
    bounded = _bounded_attrs(tree)

    def marked(lineno: int) -> bool:
        line = lines[lineno - 1] if lineno <= len(lines) else ""
        return UNBOUNDED_MARKER in line

    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        if _is_deque_call(node):
            if not any(kw.arg == "maxlen" for kw in node.keywords) \
                    and not marked(node.lineno):
                out.append(_f(
                    "rules/unbounded-queue",
                    "deque without maxlen in serving code — give it a "
                    "cap or opt out with `# lint: allow-unbounded`",
                    f"{path}:{node.lineno}"))
            continue
        if isinstance(node.func, ast.Attribute) \
                and node.func.attr in _GROW_METHODS:
            attr = _container_attr(node.func.value)
            if attr and attr not in bounded and not marked(node.lineno):
                out.append(_f(
                    "rules/unbounded-queue",
                    f"`.{node.func.attr}` grows persistent container "
                    f"{attr!r} with no visible bound in this module "
                    "(no del-trim, slice-trim, or len() guard) — a "
                    "serving process runs forever, so cap it or opt "
                    "out with `# lint: allow-unbounded`",
                    f"{path}:{node.lineno}"))
    return out


def check_source(source: str, path: str) -> list[Finding]:
    """Run every rule over one module's source."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [_f("rules/bare-assert", f"unparseable module: {e}",
                   f"{path}:{e.lineno or 0}")]
    lines = source.splitlines()
    out: list[Finding] = []
    top_pkg = path.replace(os.sep, "/").split("/")[0]
    swallow_scope = top_pkg in SWALLOW_SCOPE
    if top_pkg in QUEUE_SCOPE:
        out.extend(_check_unbounded(tree, lines, path))

    functions: dict[str, ast.FunctionDef | ast.AsyncFunctionDef] = {}
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            functions.setdefault(node.name, node)

    for node in ast.walk(tree):
        # rule: bare assert ------------------------------------------------
        if isinstance(node, ast.Assert):
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if ALLOW_MARKER not in line:
                out.append(_f(
                    "rules/bare-assert",
                    "bare `assert` in library code — stripped under "
                    "`python -O`; raise repro_torch.errors.InvariantViolation "
                    "(or a typed exception) instead",
                    f"{path}:{node.lineno}"))
        # rule: mutable default -------------------------------------------
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for pname, default in _defaults_by_param(node).items():
                if _is_mutable_literal(default):
                    out.append(_f(
                        "rules/mutable-default",
                        f"parameter {pname!r} of {node.name}() has a "
                        "mutable default — shared across every call; "
                        "default to None and construct inside",
                        f"{path}:{node.lineno}"))
            # decorator form: @partial(jax.jit, static_argnames=...)
            for dec in node.decorator_list:
                if isinstance(dec, ast.Call):
                    statics = _static_params(dec, node)
                    if statics:
                        out.extend(_check_static_defaults(
                            node, statics, path))
        # rule: swallowed exception ----------------------------------------
        if isinstance(node, ast.ExceptHandler) and swallow_scope:
            line = lines[node.lineno - 1] if node.lineno <= len(lines) else ""
            if (SWALLOW_MARKER not in line and _catches_broad(node)
                    and _swallows(node)):
                out.append(_f(
                    "rules/swallowed-exception",
                    "broad except handler silently swallows the failure — "
                    "serving/maintenance code must re-raise, roll back, "
                    "degrade, or record a fault (repro_torch.serve "
                    "telemetry); "
                    "opt out with `# lint: allow-swallow` if the silence "
                    "is the contract",
                    f"{path}:{node.lineno}"))
        # rule: jit(f, static_...) call form -------------------------------
        if isinstance(node, ast.Call):
            target = None
            if node.args and isinstance(node.args[0], ast.Name):
                target = functions.get(node.args[0].id)
            statics = _static_params(node, target)
            if statics and target is not None:
                out.extend(_check_static_defaults(target, statics, path))
    return out


def _check_static_defaults(fn, statics: list[str],
                           path: str) -> list[Finding]:
    out: list[Finding] = []
    defaults = _defaults_by_param(fn)
    for pname in statics:
        default = defaults.get(pname)
        if default is not None and _is_mutable_literal(default):
            out.append(_f(
                "rules/unhashable-static",
                f"static argument {pname!r} of jitted {fn.name}() defaults "
                "to an unhashable value — the jit cache keys on hash() and "
                "will crash the first time the default is used",
                f"{path}:{fn.lineno}"))
    return out


def iter_library_files(root: str):
    """Python files of the pipeline packages under `root` (the `repro_torch`
    package directory), honoring EXCLUDED_DIRS."""
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = sorted(d for d in dirnames if d not in EXCLUDED_DIRS)
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def run_repo_rules(root: str) -> tuple[list[Finding], int]:
    """Run every rule over the library tree; returns (findings, n_files)."""
    findings: list[Finding] = []
    n = 0
    for path in iter_library_files(root):
        with open(path, encoding="utf-8") as f:
            source = f.read()
        findings.extend(check_source(source, os.path.relpath(path, root)))
        n += 1
    return findings, n
