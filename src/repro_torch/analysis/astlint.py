"""AST lint for the repo's concurrency and determinism contracts.

Four rules, each encoding an invariant the test suite cannot cheaply
enforce at runtime:

  * **LCK001** -- a raw ``threading.Lock()`` / ``RLock()`` /
    ``Condition()`` constructed inside ``serving/`` or ``core/``.  Every
    lock there must come from the tracked factories in
    ``analysis/locks.py`` (``make_lock`` / ``make_rlock`` /
    ``make_condition``) so the lock-order graph and the
    forbidden-while-held contracts see it.  ``threading.Event`` and
    friends are fine -- only the three lockable primitives participate
    in ordering.

  * **LCK002** -- a write to a guarded shared attribute (registered in
    ``analysis/guards.py``) outside a ``with self.<lock>`` block.  Writes
    cover plain/augmented assignment, subscript stores and deletes, and
    calls to known container mutators (``append``, ``pop``, ``update``,
    ...).  Methods whose name ends in ``_locked`` assert "caller holds
    the lock" by convention and are exempt, as is ``__init__`` (the
    object is not yet shared).

  * **EXC001** -- an ``except Exception`` / ``except BaseException`` /
    bare ``except`` whose body neither re-raises, nor increments a
    telemetry counter (a ``.count(...)`` call), nor captures the
    exception object into an outer variable (the ``err = e`` respawn
    pattern).  Swallowing without any of those hides operational errors.

  * **DET001** -- a nondeterminism source in ``core/`` or ``comm/``:
    ``time.time()`` (wall clock; ``perf_counter``/``monotonic`` are fine
    and intended) or unseeded ``np.random`` access (anything except
    ``np.random.default_rng(seed)`` / ``np.random.Generator``).  Core
    synthesis must be a pure function of its inputs so plans replay
    bit-identically -- and the comm layer's plan lowering
    (``comm/plan_exec.py``) bakes those plans into traced programs, so
    the same determinism contract extends to it.

Suppression: append ``# noqa: LCK001`` (or the relevant rule id, comma
separated) to the offending line.  A bare ``# noqa`` silences every rule
on that line, matching the flake8 convention.
"""

from __future__ import annotations

import ast
import os
import re
from typing import Dict, List, NamedTuple, Optional, Sequence, Set, Tuple

from . import guards

__all__ = ["Finding", "lint_source", "lint_file", "lint_paths",
           "lint_tree", "RULES"]

RULES = ("LCK001", "LCK002", "EXC001", "DET001")

# Container mutators that modify a guarded attribute in place; calling one
# outside the guard lock is as racy as assigning to the attribute.
_MUTATORS = frozenset({
    "add", "append", "appendleft", "clear", "discard", "extend",
    "insert", "move_to_end", "pop", "popitem", "popleft", "remove",
    "setdefault", "update",
})

_LOCK_CTORS = frozenset({"Lock", "RLock", "Condition"})

_NOQA_RE = re.compile(r"#\s*noqa(?::\s*(?P<rules>[A-Z0-9, ]+))?",
                      re.IGNORECASE)


class Finding(NamedTuple):
    rule: str
    path: str
    line: int
    message: str

    def format(self) -> str:
        return f"{self.path}:{self.line}: {self.rule} {self.message}"

    def to_dict(self) -> Dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "message": self.message}


def _noqa_rules(source_line: str) -> Optional[Set[str]]:
    """The rule ids a ``# noqa`` comment on this line silences, the empty
    set for a bare ``# noqa`` (silence everything), None when absent."""
    m = _NOQA_RE.search(source_line)
    if m is None:
        return None
    rules = m.group("rules")
    if rules is None:
        return set()
    return {r.strip().upper() for r in rules.split(",") if r.strip()}


def _suppressed(lines: Sequence[str], lineno: int, rule: str) -> bool:
    if not 1 <= lineno <= len(lines):
        return False
    rules = _noqa_rules(lines[lineno - 1])
    if rules is None:
        return False
    return not rules or rule in rules


def _is_self_attr(node: ast.AST, attrs: frozenset) -> Optional[str]:
    """The attribute name when ``node`` is ``self.<attr>`` with ``attr``
    in ``attrs``, else None."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
            and node.attr in attrs):
        return node.attr
    return None


def _withitem_locks(stmt: ast.With) -> Set[str]:
    """Attribute names of every ``self.<attr>`` context manager in a
    ``with`` statement (``with self._lock:`` -> {"_lock"})."""
    out: Set[str] = set()
    for item in stmt.items:
        ctx = item.context_expr
        if (isinstance(ctx, ast.Attribute)
                and isinstance(ctx.value, ast.Name)
                and ctx.value.id == "self"):
            out.add(ctx.attr)
    return out


class _Linter(ast.NodeVisitor):
    def __init__(self, path: str, lines: Sequence[str],
                 guard_specs: Dict[str, Tuple[str, frozenset]],
                 check_lck001: bool, check_det001: bool):
        self.path = path
        self.lines = lines
        self.guard_specs = guard_specs  # class name -> (lock_attr, attrs)
        self.check_lck001 = check_lck001
        self.check_det001 = check_det001
        self.findings: List[Finding] = []
        # LCK002 state, valid only while walking a guarded class body.
        self._guard: Optional[Tuple[str, frozenset]] = None
        self._held: List[str] = []  # stack of with-held self.<attr> names
        self._exempt_method = False

    def _emit(self, rule: str, node: ast.AST, message: str) -> None:
        if _suppressed(self.lines, node.lineno, rule):
            return
        self.findings.append(Finding(rule, self.path, node.lineno, message))

    # -- LCK001 -----------------------------------------------------------

    def visit_Call(self, node: ast.Call) -> None:
        if self.check_lck001:
            fn = node.func
            name = None
            if (isinstance(fn, ast.Attribute)
                    and isinstance(fn.value, ast.Name)
                    and fn.value.id == "threading"):
                name = fn.attr
            elif isinstance(fn, ast.Name):
                name = fn.id if fn.id in _LOCK_CTORS else None
            if name in _LOCK_CTORS:
                self._emit(
                    "LCK001", node,
                    f"raw threading.{name}() -- use the tracked factory "
                    f"make_{'condition' if name == 'Condition' else name.lower()}"  # noqa: E501
                    "(name) from repro_torch.analysis.locks so the lock "
                    "participates in lock-order analysis")
        if self._lck002_active():
            self._check_mutator_call(node)
        if self.check_det001:
            self._check_det001_call(node)
        self.generic_visit(node)

    # -- DET001 -----------------------------------------------------------

    def _check_det001_call(self, node: ast.Call) -> None:
        fn = node.func
        # time.time()
        if (isinstance(fn, ast.Attribute) and fn.attr == "time"
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "time"):
            self._emit("DET001", node,
                       "wall-clock time.time() in core/ -- use "
                       "time.perf_counter() (interval) or take the "
                       "timestamp as a parameter")
        # np.random.<anything but default_rng/Generator>
        if (isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Attribute)
                and fn.value.attr == "random"
                and isinstance(fn.value.value, ast.Name)
                and fn.value.value.id in ("np", "numpy")):
            if fn.attr not in ("default_rng", "Generator"):
                self._emit("DET001", node,
                           f"np.random.{fn.attr}() uses the unseeded "
                           "global RNG in core/ -- thread an explicit "
                           "np.random.default_rng(seed) through instead")

    # -- EXC001 -----------------------------------------------------------

    def visit_ExceptHandler(self, node: ast.ExceptHandler) -> None:
        broad = node.type is None or (
            isinstance(node.type, ast.Name)
            and node.type.id in ("Exception", "BaseException"))
        if broad and not self._exc_body_ok(node):
            caught = (node.type.id if isinstance(node.type, ast.Name)
                      else "everything")
            self._emit(
                "EXC001", node,
                f"broad except {caught} swallows the error: re-raise, "
                "count it in telemetry, or capture the exception for a "
                "later re-raise")
        self.generic_visit(node)

    @staticmethod
    def _exc_body_ok(node: ast.ExceptHandler) -> bool:
        captured = node.name  # `except Exception as e` -> "e"
        for stmt in ast.walk(ast.Module(body=node.body,
                                        type_ignores=[])):
            if isinstance(stmt, ast.Raise):
                return True
            if (isinstance(stmt, ast.Call)
                    and isinstance(stmt.func, ast.Attribute)
                    and stmt.func.attr == "count"):
                return True
            if (captured and isinstance(stmt, ast.Assign)
                    and isinstance(stmt.value, ast.Name)
                    and stmt.value.id == captured):
                return True
        return False

    # -- LCK002 -----------------------------------------------------------

    def _lck002_active(self) -> bool:
        return (self._guard is not None and not self._exempt_method
                and self._guard[0] not in self._held)

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        prev = self._guard
        self._guard = self.guard_specs.get(node.name)
        self.generic_visit(node)
        self._guard = prev

    def _visit_function(self, node) -> None:
        prev = self._exempt_method
        self._exempt_method = (node.name == "__init__"
                               or node.name.endswith("_locked"))
        self.generic_visit(node)
        self._exempt_method = prev

    visit_FunctionDef = _visit_function
    visit_AsyncFunctionDef = _visit_function

    def visit_With(self, node: ast.With) -> None:
        held = _withitem_locks(node)
        self._held.extend(held)
        self.generic_visit(node)
        del self._held[len(self._held) - len(held):]

    def _guarded_attr(self, node: ast.AST) -> Optional[str]:
        """The guarded attribute a store-target touches, if any: plain
        ``self.attr``, ``self.attr[k]`` stores, and their Starred/Tuple
        unpacking forms."""
        if self._guard is None:
            return None
        _, attrs = self._guard
        if isinstance(node, (ast.Tuple, ast.List)):
            for elt in node.elts:
                hit = self._guarded_attr(elt)
                if hit:
                    return hit
            return None
        if isinstance(node, ast.Starred):
            return self._guarded_attr(node.value)
        if isinstance(node, ast.Subscript):
            return self._guarded_attr(node.value)
        return _is_self_attr(node, attrs)

    def _emit_lck002(self, node: ast.AST, attr: str, what: str) -> None:
        lock_attr = self._guard[0]
        self._emit(
            "LCK002", node,
            f"{what} guarded attribute self.{attr} outside "
            f"`with self.{lock_attr}` (rename the method *_locked if the "
            "caller provably holds the lock)")

    def visit_Assign(self, node: ast.Assign) -> None:
        if self._lck002_active():
            for tgt in node.targets:
                attr = self._guarded_attr(tgt)
                if attr:
                    self._emit_lck002(node, attr, "write to")
                    break
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        if self._lck002_active():
            attr = self._guarded_attr(node.target)
            if attr:
                self._emit_lck002(node, attr, "augmented write to")
        self.generic_visit(node)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if self._lck002_active() and node.value is not None:
            attr = self._guarded_attr(node.target)
            if attr:
                self._emit_lck002(node, attr, "write to")
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        if self._lck002_active():
            for tgt in node.targets:
                attr = self._guarded_attr(tgt)
                if attr:
                    self._emit_lck002(node, attr, "delete on")
                    break
        self.generic_visit(node)

    def _check_mutator_call(self, node: ast.Call) -> None:
        fn = node.func
        if not (isinstance(fn, ast.Attribute) and fn.attr in _MUTATORS):
            return
        _, attrs = self._guard
        attr = _is_self_attr(fn.value, attrs)
        if attr is None and isinstance(fn.value, ast.Subscript):
            attr = _is_self_attr(fn.value.value, attrs)
        if attr:
            self._emit_lck002(node, attr, f".{fn.attr}() on")


def _guard_specs_for_module(rel_module: str
                            ) -> Dict[str, Tuple[str, frozenset]]:
    """LCK002 specs applicable to one module, keyed by class name."""
    out: Dict[str, Tuple[str, frozenset]] = {}
    for spec in guards.REGISTRY:
        if spec.module == rel_module:
            out[spec.cls_name] = (spec.lock_attr, frozenset(spec.attrs))
    return out


def _module_name(path: str, root: str) -> str:
    """Dotted module path of ``path`` relative to the src root, e.g.
    ``.../src/repro_torch/serving/server.py`` ->
    ``repro_torch.serving.server``."""
    rel = os.path.relpath(os.path.abspath(path), os.path.abspath(root))
    rel = rel[:-3] if rel.endswith(".py") else rel
    return rel.replace(os.sep, ".")


def lint_source(source: str, path: str = "<string>", *,
                module: str = "",
                check_lck001: bool = True,
                check_det001: bool = False,
                guard_specs: Optional[Dict] = None) -> List[Finding]:
    """Lint one module's source text; the testable core of the pass."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding("EXC001", path, e.lineno or 0,
                        f"unparseable module: {e.msg}")]
    lines = source.splitlines()
    specs = (guard_specs if guard_specs is not None
             else _guard_specs_for_module(module))
    linter = _Linter(path, lines, specs, check_lck001, check_det001)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: (f.line, f.rule))


def lint_file(path: str, src_root: str) -> List[Finding]:
    module = _module_name(path, src_root)
    parts = module.split(".")
    # DET001 (replay determinism) covers synthesis (core/) and the plan
    # lowering that bakes plans into traced programs (comm/).
    check_det = "core" in parts or "comm" in parts
    in_scope = check_det or "serving" in parts
    if not in_scope:
        return []
    with open(path, "r") as f:
        source = f.read()
    return lint_source(source, path, module=module,
                       check_lck001=True, check_det001=check_det)


def lint_paths(paths: Sequence[str], src_root: str) -> List[Finding]:
    findings: List[Finding] = []
    for path in paths:
        findings.extend(lint_file(path, src_root))
    return findings


def lint_tree(src_root: str) -> List[Finding]:
    """Lint every ``core/``, ``comm/`` and ``serving/`` module under
    ``src_root`` (the directory containing the ``repro_torch`` package)."""
    paths = []
    for sub in ("repro_torch/core", "repro_torch/comm",
                "repro_torch/serving"):
        d = os.path.join(src_root, sub)
        if not os.path.isdir(d):
            continue
        for name in sorted(os.listdir(d)):
            if name.endswith(".py"):
                paths.append(os.path.join(d, name))
    return lint_paths(paths, src_root)
