"""Lint of the port's source: AST rules for the kernel wrappers' and the
engine's invariants.  The port's copy of ``repro.analysis.lint``.

Rules (see ``findings.RULES`` / ``analysis/README.md``):

* **R001** — every call into ``_build.library()`` (a C entry point of the
  kernels) assigns its return code to a name that the same function then
  hands to ``_build.check``: a launch the runtime refused never runs, and
  a later synchronize would not say so.  The counterpart of JAX's R001
  (every ``pallas_call`` threads ``interpret=`` and
  ``compiler_params=``): the part of a launch that must never be left
  out.
* **R002** — the engine's knob machinery cannot regress into the
  stale-plan bug: ``_KnobDict`` mutators must reach ``_on_change``
  (directly or by delegating to a checked mutator), class-level
  ``name = _knob("name")`` descriptors must name the attribute they
  wrap, and ``clear_caches`` must clear every cache dict ``__init__``
  creates.
* **R004** — no silent handlers: a bare/broad ``except`` whose body is
  only ``pass``/``...`` swallows planner and IO failures.
* **R005** — byte budgets appear in comparisons only through the named
  kernel constants, never as magic numbers (≥ 1 MiB literals).
* **R006** — serving-path supervision cannot swallow errors: every
  ``except`` handler in a ``serving/`` module must re-raise, reference
  its bound exception, or name a typed failure result.
* **R007** — the ``ACC_DTYPE`` discipline of the plain versions: inside
  ``kernels/``, a plain version (a function of a ``ref.py`` module or
  one whose name ends in ``_ref``) converts with ``.to(...)`` only to
  the named ``ACC_DTYPE`` or a tensor's ``.dtype``, never to an inline
  float dtype (``torch.float32``, ``"float64"``, ``.float()``): an
  inline dtype forks the fp32-accumulate / single-cast contract the
  kernels are held to.  The counterpart of JAX's R007 (kernel-body
  ``astype``).

* **R008** — the guard pass's hook: a function of a wrapper module
  (``kernels/*/ops.py``) that calls ``_build.library()`` allocates no
  tensor with ``torch.empty``, ``zeros``, ``empty_like`` or
  ``zeros_like``; it goes through ``common.alloc``, which guard mode
  (``analysis/guard.py``) turns into a guarded, prefilled buffer.  An
  allocation past the hook is a tensor the guard pass cannot check.

JAX's R003 (``pl.Unblocked`` index maps) reads Pallas source and has no
counterpart.  All rules are file-local AST walks — no imports of the
linted modules, so the linter runs on any tree (including deliberately
broken test snippets).
"""
from __future__ import annotations

import ast
from pathlib import Path
from typing import Iterable, List, Optional

from repro_torch.analysis.findings import Finding

#: _KnobDict methods that mutate the mapping (must invalidate)
KNOB_DICT_MUTATORS = frozenset({
    "__setitem__", "__delitem__", "__ior__", "update", "setdefault",
    "pop", "popitem", "clear",
})

#: caches clear_caches must drop (matched against __init__-created dicts)
_CACHE_HINTS = ("plan", "jit", "bucket", "cache")

_MAGIC_BUDGET_MIN = 1 << 20  # 1 MiB: anything this big is a byte budget


def _call_name(node: ast.Call) -> str:
    """Dotted tail of a call target: ``_build.check`` -> ``check``."""
    f = node.func
    if isinstance(f, ast.Attribute):
        return f.attr
    if isinstance(f, ast.Name):
        return f.id
    return ""


def _loc(path: str, node: ast.AST) -> str:
    return f"{path}:{getattr(node, 'lineno', 0)}"


# -- R001 -------------------------------------------------------------------

def _is_library(node: ast.AST, libs) -> bool:
    """``_build.library()`` / ``library()``, or a name bound to it."""
    if isinstance(node, ast.Call) and _call_name(node) == "library":
        return True
    return isinstance(node, ast.Name) and node.id in libs


def _is_entry_call(node: ast.AST, libs) -> bool:
    """A call of a C entry: ``<library>.name(...)`` or
    ``getattr(<library>, name)(...)``."""
    if not isinstance(node, ast.Call):
        return False
    f = node.func
    if isinstance(f, ast.Attribute):
        return _is_library(f.value, libs)
    return (isinstance(f, ast.Call) and isinstance(f.func, ast.Name)
            and f.func.id == "getattr" and bool(f.args)
            and _is_library(f.args[0], libs))


def _r001(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef,
                               ast.Module)):
            continue
        body = [n for stmt in fn.body for n in ast.walk(stmt)]
        libs = {t.id for n in body if isinstance(n, ast.Assign)
                and isinstance(n.value, ast.Call)
                and _call_name(n.value) == "library"
                for t in n.targets if isinstance(t, ast.Name)}
        checked = {(n.args[0].id, n.lineno) for n in body
                   if isinstance(n, ast.Call) and _call_name(n) == "check"
                   and n.args and isinstance(n.args[0], ast.Name)}
        rc_of = {id(n.value): n for n in body if isinstance(n, ast.Assign)
                 and len(n.targets) == 1
                 and isinstance(n.targets[0], ast.Name)}
        nested = {id(n) for d in body
                  if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(d)}
        for node in body:
            if id(node) in nested or not _is_entry_call(node, libs):
                continue
            assign = rc_of.get(id(node))
            rc = assign.targets[0].id if assign is not None else None
            if rc is None or not any(name == rc and line >= assign.lineno
                                     for name, line in checked):
                out.append(Finding(
                    "error", _loc(path, node), "R001",
                    "C entry call whose return code does not reach "
                    "_build.check: a refused launch would pass silently"))
    return out


# -- R002 -------------------------------------------------------------------

def _calls_in(node: ast.AST) -> Iterable[ast.Call]:
    return (n for n in ast.walk(node) if isinstance(n, ast.Call))


def _r002_knob_dict(cls: ast.ClassDef, path: str) -> List[Finding]:
    out = []
    for item in cls.body:
        if not isinstance(item, ast.FunctionDef):
            continue
        if item.name not in KNOB_DICT_MUTATORS or item.name == "__init__":
            continue
        ok = False
        for call in _calls_in(item):
            f = call.func
            if (isinstance(f, ast.Attribute)
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "self"
                    and (f.attr == "_on_change"
                         or f.attr in KNOB_DICT_MUTATORS)):
                ok = True
                break
        if not ok:
            out.append(Finding(
                "error", _loc(path, item), "R002",
                f"_KnobDict.{item.name} mutates without reaching "
                f"_on_change (stale-plan bug class)"))
    return out


def _r002_knob_names(cls: ast.ClassDef, path: str) -> List[Finding]:
    out = []
    for item in cls.body:
        if not (isinstance(item, ast.Assign) and len(item.targets) == 1
                and isinstance(item.targets[0], ast.Name)
                and isinstance(item.value, ast.Call)
                and _call_name(item.value) in ("_knob", "_dict_knob")):
            continue
        args = item.value.args
        if (len(args) != 1 or not isinstance(args[0], ast.Constant)
                or args[0].value != item.targets[0].id):
            out.append(Finding(
                "error", _loc(path, item), "R002",
                f"knob descriptor {item.targets[0].id} must wrap the "
                f"attribute of the same name"))
    return out


def _r002_clear_caches(cls: ast.ClassDef, path: str) -> List[Finding]:
    init = next((f for f in cls.body if isinstance(f, ast.FunctionDef)
                 and f.name == "__init__"), None)
    clear = next((f for f in cls.body if isinstance(f, ast.FunctionDef)
                  and f.name == "clear_caches"), None)
    if init is None or clear is None:
        return []
    caches = set()
    for node in ast.walk(init):
        tgt = None
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            tgt, val = node.targets[0], node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            tgt, val = node.target, node.value
        else:
            continue
        if (isinstance(tgt, ast.Attribute) and isinstance(tgt.value, ast.Name)
                and tgt.value.id == "self" and isinstance(val, ast.Dict)
                and any(h in tgt.attr.lower() for h in _CACHE_HINTS)):
            caches.add(tgt.attr)
    touched = {n.attr for n in ast.walk(clear)
               if isinstance(n, ast.Attribute)
               and isinstance(n.value, ast.Name) and n.value.id == "self"}
    out = []
    for name in sorted(caches - touched):
        out.append(Finding(
            "error", _loc(path, clear), "R002",
            f"clear_caches does not clear self.{name} created in __init__"))
    return out


def _r002(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ClassDef):
            continue
        if node.name == "_KnobDict":
            out += _r002_knob_dict(node, path)
        out += _r002_knob_names(node, path)
        out += _r002_clear_caches(node, path)
    return out


# -- R004 -------------------------------------------------------------------

def _is_broad(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    for n in ast.walk(t):
        if isinstance(n, ast.Attribute):
            names.append(n.attr)
        elif isinstance(n, ast.Name):
            names.append(n.id)
    return any(n in ("Exception", "BaseException") for n in names)


def _r004(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        body_is_silent = all(
            isinstance(s, ast.Pass)
            or (isinstance(s, ast.Expr) and isinstance(s.value, ast.Constant)
                and s.value.value is Ellipsis)
            for s in node.body)
        if body_is_silent and _is_broad(node):
            out.append(Finding(
                "error", _loc(path, node), "R004",
                "silent broad except: narrow the exception and handle (or "
                "at least record) the failure"))
    return out


# -- R005 -------------------------------------------------------------------

_FOLD_OPS = {ast.Add: lambda a, b: a + b, ast.Sub: lambda a, b: a - b,
             ast.Mult: lambda a, b: a * b, ast.LShift: lambda a, b: a << b,
             ast.Pow: lambda a, b: a ** b}


def _const_int(node: ast.AST) -> Optional[int]:
    """Fold a constants-only arithmetic expression (``8 * 1024 * 1024``,
    ``14 << 20``) to its int value; None if any leaf is a name."""
    if (isinstance(node, ast.Constant) and isinstance(node.value, int)
            and not isinstance(node.value, bool)):
        return node.value
    if isinstance(node, ast.BinOp) and type(node.op) in _FOLD_OPS:
        left, right = _const_int(node.left), _const_int(node.right)
        if left is not None and right is not None:
            return _FOLD_OPS[type(node.op)](left, right)
    return None


def _r005(tree: ast.AST, path: str) -> List[Finding]:
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.Compare):
            continue
        for side in [node.left, *node.comparators]:
            value = _const_int(side)
            if value is not None and value >= _MAGIC_BUDGET_MIN:
                out.append(Finding(
                    "warning", _loc(path, node), "R005",
                    f"magic byte budget {value} in a comparison — use "
                    f"the named kernel budget constants"))
    return out


# -- R006 -------------------------------------------------------------------

#: typed failure results / fault types whose mention in a handler counts
#: as recording the error (the serving failure taxonomy)
R006_TYPED_NAMES = frozenset({
    "FailedResult", "ShedResult", "EngineFault", "TransientEngineFault",
    "PersistentEngineFault", "ServerWedgedError", "NonFiniteInputError",
})


def _r006(tree: ast.AST, path: str) -> List[Finding]:
    """serving/ except handlers must re-raise or record a typed failure
    (no swallowed supervisor errors).  File-scoped: the rule only binds
    on modules under a ``serving/`` directory."""
    if "serving/" not in path.replace("\\", "/"):
        return []
    out = []
    for node in ast.walk(tree):
        if not isinstance(node, ast.ExceptHandler):
            continue
        body_nodes = [n for stmt in node.body for n in ast.walk(stmt)]
        if any(isinstance(n, ast.Raise) for n in body_nodes):
            continue
        names = {n.id for n in body_nodes if isinstance(n, ast.Name)}
        names |= {n.attr for n in body_nodes if isinstance(n, ast.Attribute)}
        if node.name and node.name in names:
            continue  # the bound exception is used: the error is recorded
        if names & R006_TYPED_NAMES:
            continue  # a typed failure result is produced
        out.append(Finding(
            "error", _loc(path, node), "R006",
            "serving/ except handler neither re-raises, uses its bound "
            "exception, nor records a typed failure result — the "
            "supervisor error is swallowed"))
    return out


# -- R007 -------------------------------------------------------------------

#: inline float dtypes: torch attributes, strings, and conversion methods
_FLOAT_DTYPES = frozenset({"float32", "float64", "float16", "bfloat16",
                           "half", "float", "double"})
_FLOAT_METHODS = frozenset({"float", "double", "half", "bfloat16"})


def _is_plain_version(fn: ast.FunctionDef, path: str) -> bool:
    return path.replace("\\", "/").endswith("ref.py") or fn.name.endswith(
        "_ref")


def _inline_dtype(node: ast.AST) -> bool:
    if isinstance(node, ast.Attribute):
        return node.attr in _FLOAT_DTYPES
    return isinstance(node, ast.Constant) and node.value in _FLOAT_DTYPES


def _r007(tree: ast.AST, path: str) -> List[Finding]:
    """kernels/ plain versions: ``.to(...)`` targets ``ACC_DTYPE`` or a
    tensor's ``.dtype`` (``x.dtype`` is an Attribute named ``dtype``,
    never an inline dtype)."""
    if "kernels/" not in path.replace("\\", "/"):
        return []
    out, seen = [], set()
    for fn in ast.walk(tree):
        if not (isinstance(fn, ast.FunctionDef)
                and _is_plain_version(fn, path)):
            continue
        for node in ast.walk(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            args = list(node.args) + [kw.value for kw in node.keywords
                                      if kw.arg == "dtype"]
            bad = ((attr == "to" and any(_inline_dtype(a) for a in args))
                   or (attr in _FLOAT_METHODS and not node.args))
            key = (node.lineno, node.col_offset)
            if not bad or key in seen:  # nested fns walk a call twice
                continue
            seen.add(key)
            out.append(Finding(
                "error", _loc(path, node), "R007",
                "plain-version conversion to an inline float dtype: use "
                "ACC_DTYPE (or a tensor's .dtype) so the fp32 accumulate "
                "/ single-cast contract stays one named constant"))
    return out


# -- R008 -------------------------------------------------------------------

#: torch allocations a launching wrapper makes through ``common.alloc``
_R008_ALLOCS = frozenset({"empty", "zeros", "empty_like", "zeros_like"})


def _r008(tree: ast.AST, path: str) -> List[Finding]:
    """kernels/*/ops.py: a function that calls ``library()`` makes no
    ``torch.<alloc>(...)`` call (nested functions count on their own)."""
    parts = path.replace("\\", "/").split("/")
    if len(parts) < 3 or parts[-3:][0] != "kernels" or parts[-1] != "ops.py":
        return []
    out = []
    for fn in ast.walk(tree):
        if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        nested = {id(n) for d in ast.walk(fn) if d is not fn and isinstance(
            d, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            for n in ast.walk(d)}
        calls = [n for n in ast.walk(fn) if isinstance(n, ast.Call)
                 and id(n) not in nested]
        if not any(_call_name(c) == "library" for c in calls):
            continue
        for c in calls:
            f = c.func
            if (isinstance(f, ast.Attribute) and f.attr in _R008_ALLOCS
                    and isinstance(f.value, ast.Name)
                    and f.value.id == "torch"):
                out.append(Finding(
                    "error", _loc(path, c), "R008",
                    f"torch.{f.attr} in a function that launches a kernel: "
                    f"allocate through common.alloc, so that the guard pass "
                    f"can guard and prefill the tensor"))
    return out


_RULES = (_r001, _r002, _r004, _r005, _r006, _r007, _r008)


def lint_source(src: str, path: str = "<string>",
                rules: Optional[Iterable] = None) -> List[Finding]:
    """Lint one source string (the unit the seeded-snippet tests use)."""
    tree = ast.parse(src)
    out: List[Finding] = []
    for rule in (rules or _RULES):
        out += rule(tree, path)
    return out


def lint_file(path: Path, root: Optional[Path] = None) -> List[Finding]:
    rel = str(path.relative_to(root)) if root else str(path)
    return lint_source(path.read_text(), rel)


def lint_tree(root: Path) -> List[Finding]:
    """Lint every ``*.py`` under ``root`` (sorted, deterministic)."""
    root = Path(root)
    out: List[Finding] = []
    for path in sorted(root.rglob("*.py")):
        out += lint_file(path, root.parent)
    return out
