"""Static call-interface gate — the JET *type-analysis* analogue.

The reference's second blocking gate is ``JET.test_package``
(``/root/reference/test/runtests.jl:108-110``): abstract-interpretation
type analysis that catches wrong call signatures, bad keyword arguments,
and unresolvable bindings before any test runs.  Python ships no such
checker and installing one (mypy/pyright) is forbidden, so this module
implements the subset of JET findings that dominate in practice for an
untyped codebase, by combining **static call sites** (``ast``) with
**runtime signatures** (``inspect``) of the imported package:

* **call-arity**   — a call to a package-defined function/class binds
  too many positional arguments or omits a required parameter.
* **call-kwarg**   — a call passes a keyword the callee doesn't accept.
* **bad-annotation** — ``typing.get_type_hints`` fails on a public
  function/class of the package (stale or misspelled annotation —
  otherwise unverified decoration).

Soundness stance: **zero false positives over completeness**.  A call is
only checked when the callee resolves *unambiguously* to a callable whose
``__module__`` is inside the package:

- ``f(...)`` where ``f`` is bound at module scope (def/class/import) and
  never rebound in any enclosing function scope;
- ``a.b.c(...)`` resolved by runtime ``getattr`` through modules/classes;
- ``self.m(...)`` / ``cls.m(...)`` inside a module-level class, resolved
  through the runtime MRO (``inspect.getattr_static``).

Calls with ``*args``/``**kwargs`` at the call site skip the corresponding
check (they may legally supply anything); callees with ``*args`` or
``**kwargs`` parameters absorb what we cannot prove wrong.  Binding is
checked with ``inspect.Signature.bind`` itself, so the semantics are
exactly CPython's.

Run: ``python tools/typecheck.py [paths...]`` — exits non-zero with one
``path:line:col code message`` finding per line.  Gated by ``make lint``
and ``tests/test_typecheck.py`` (which seeds synthetic errors to prove
detection).
"""

from __future__ import annotations

import ast
import importlib
import inspect
import sys
import typing
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, Iterator, List, Optional, Set, Tuple

REPO = Path(__file__).resolve().parents[1]
PACKAGE = "cortex_tpu"

if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

Finding = Tuple[str, int, int, str, str]  # path, line, col, code, message

_MISSING = object()


# ---------------------------------------------------------------------------
# Static side: which names are locally rebound (must then be skipped)?
# ---------------------------------------------------------------------------


def _binds_in_scope(fn: ast.AST) -> Set[str]:
    """All names bound inside a function scope, NOT descending into nested
    function/class scopes (their binds don't shadow the enclosing frame at
    the call site) — parameters, assignments, imports, with/for targets,
    comprehension targets, walrus, except aliases."""
    out: Set[str] = set()
    if isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        a = fn.args
        for p in (
            list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs)
        ):
            out.add(p.arg)
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)
    elif isinstance(fn, ast.Lambda):
        a = fn.args
        for p in list(a.posonlyargs) + list(a.args) + list(a.kwonlyargs):
            out.add(p.arg)
        if a.vararg:
            out.add(a.vararg.arg)
        if a.kwarg:
            out.add(a.kwarg.arg)

    def walk(node: ast.AST) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)
            ):
                out.add(getattr(child, "name", ""))
                continue  # don't descend: inner scope
            if isinstance(child, ast.ClassDef):
                out.add(child.name)
                continue
            if isinstance(child, ast.Name) and isinstance(
                child.ctx, (ast.Store, ast.Del)
            ):
                out.add(child.id)
            elif isinstance(child, ast.ExceptHandler) and child.name:
                out.add(child.name)
            elif isinstance(child, (ast.Import, ast.ImportFrom)):
                for alias in child.names:
                    out.add((alias.asname or alias.name).split(".")[0])
            elif isinstance(child, ast.Global) or isinstance(
                child, ast.Nonlocal
            ):
                for n in child.names:
                    out.add(n)
            walk(child)
        return None

    body = fn.body if isinstance(fn.body, list) else [fn.body]
    for stmt in body:
        walk(stmt)
        if isinstance(stmt, ast.Name) and isinstance(
            stmt.ctx, (ast.Store, ast.Del)
        ):
            out.add(stmt.id)
    return out


class _CallCollector(ast.NodeVisitor):
    """Collect (call, enclosing-scope-chain, enclosing-class) triples."""

    def __init__(self) -> None:
        self.calls: List[Tuple[ast.Call, List[ast.AST], Optional[str]]] = []
        self._scopes: List[ast.AST] = []
        self._classes: List[Optional[str]] = [None]

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._scopes.append(node)
        # a def inside a class body: methods don't see the class scope,
        # and nested classes are not resolved — push current class through
        self.generic_visit(node)
        self._scopes.pop()

    visit_AsyncFunctionDef = visit_FunctionDef  # type: ignore[assignment]

    def visit_Lambda(self, node: ast.Lambda) -> None:
        self._scopes.append(node)
        self.generic_visit(node)
        self._scopes.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        # only module-level classes are resolvable against the runtime module
        top = len(self._scopes) == 0 and self._classes[-1] is None
        self._classes.append(node.name if top else None)
        self.generic_visit(node)
        self._classes.pop()

    def visit_Call(self, node: ast.Call) -> None:
        self.calls.append((node, list(self._scopes), self._classes[-1]))
        self.generic_visit(node)


# ---------------------------------------------------------------------------
# Runtime side: resolve the callee and check the binding
# ---------------------------------------------------------------------------


def _module_name_for(path: Path) -> Optional[str]:
    try:
        rel = path.resolve().relative_to(REPO)
    except ValueError:
        return None
    if rel.parts[0] != PACKAGE:
        return None
    parts = list(rel.with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve_attr_chain(
    base: Any, attrs: List[str]
) -> Any:
    """getattr through modules/classes only (plus a final attribute on an
    arbitrary object, which yields a bound method with self filled)."""
    import warnings

    obj = base
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # deprecated third-party attrs
        for i, name in enumerate(attrs):
            if not isinstance(obj, (ModuleType, type)) and i < len(attrs) - 1:
                return _MISSING  # don't walk chains through instances
            obj = getattr(obj, name, _MISSING)
            if obj is _MISSING:
                return _MISSING
    return obj


def _attr_parts(node: ast.expr) -> Optional[Tuple[str, List[str]]]:
    attrs: List[str] = []
    while isinstance(node, ast.Attribute):
        attrs.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        return node.id, list(reversed(attrs))
    return None


def _in_package(obj: Any) -> bool:
    mod = getattr(obj, "__module__", None) or ""
    return mod == PACKAGE or mod.startswith(PACKAGE + ".")


def _callable_and_sig(obj: Any) -> Optional[inspect.Signature]:
    """Signature used for binding *as called* (self/cls already handled)."""
    try:
        return inspect.signature(obj)
    except (ValueError, TypeError):
        return None


def _method_signature(cls: type, name: str) -> Optional[inspect.Signature]:
    """Signature of ``self.name(...)`` as seen at the call site (self bound)."""
    raw = inspect.getattr_static(cls, name, _MISSING)
    if raw is _MISSING:
        return None
    if isinstance(raw, staticmethod):
        return _callable_and_sig(raw.__func__)
    if isinstance(raw, classmethod):
        sig = _callable_and_sig(raw.__func__)
        return _drop_first(sig)
    if isinstance(raw, property):
        return None  # not a call on the descriptor
    if inspect.isfunction(raw):
        if not _in_package(raw):
            return None
        return _drop_first(_callable_and_sig(raw))
    return None


def _drop_first(sig: Optional[inspect.Signature]) -> Optional[inspect.Signature]:
    if sig is None:
        return None
    params = list(sig.parameters.values())
    if not params:
        return None
    if params[0].kind in (
        inspect.Parameter.VAR_POSITIONAL,
        inspect.Parameter.VAR_KEYWORD,
    ):
        return sig
    return sig.replace(parameters=params[1:])


class _S:
    """Opaque argument sentinel for Signature.bind."""

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return "<arg>"


def _check_call(
    sig: inspect.Signature, call: ast.Call
) -> Optional[str]:
    """Return an error message if the static call cannot bind, else None."""
    has_star = any(isinstance(a, ast.Starred) for a in call.args)
    has_dstar = any(kw.arg is None for kw in call.keywords)
    pos = [a for a in call.args if not isinstance(a, ast.Starred)]
    kws = [kw.arg for kw in call.keywords if kw.arg is not None]

    params = sig.parameters.values()
    has_varkw = any(
        p.kind == inspect.Parameter.VAR_KEYWORD for p in params
    )

    # Unknown-keyword check: valid even with extra positional uncertainty,
    # unless the callee absorbs via **kwargs.
    if not has_varkw:
        names = {
            p.name
            for p in params
            if p.kind
            in (
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.KEYWORD_ONLY,
            )
        }
        for k in kws:
            if k not in names:
                return f"unexpected keyword argument '{k}'"

    if has_star or has_dstar:
        return None  # cannot prove arity statically

    try:
        sig.bind(*([_S()] * len(pos)), **{k: _S() for k in kws})
    except TypeError as e:
        return str(e)
    return None


def _first_param_is(fn: Optional[ast.AST], name: str) -> bool:
    if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return False
    params = list(fn.args.posonlyargs) + list(fn.args.args)
    return bool(params) and params[0].arg == name


def _iter_py(paths: List[str]) -> Iterator[Path]:
    for p in paths:
        path = Path(p)
        if path.is_dir():
            yield from sorted(path.rglob("*.py"))
        elif path.suffix == ".py":
            yield path


def check_calls(path: Path, module: ModuleType) -> List[Finding]:
    src = path.read_text()
    try:
        tree = ast.parse(src)
    except SyntaxError as e:  # pragma: no cover - lint.py owns this
        return [(str(path), e.lineno or 0, 0, "syntax", str(e))]

    collector = _CallCollector()
    collector.visit(tree)
    findings: List[Finding] = []
    scope_binds: Dict[int, Set[str]] = {}

    def _binds(s: ast.AST, name: str) -> bool:
        key = id(s)
        if key not in scope_binds:
            scope_binds[key] = _binds_in_scope(s)
        return name in scope_binds[key]

    def locally_bound(name: str, scopes: List[ast.AST]) -> bool:
        return any(_binds(s, name) for s in scopes)

    for call, scopes, cls_name in collector.calls:
        func = call.func
        sig: Optional[inspect.Signature] = None
        label = ""

        if isinstance(func, ast.Name):
            if locally_bound(func.id, scopes):
                continue
            obj = getattr(module, func.id, _MISSING)
            if obj is _MISSING or not callable(obj):
                continue
            if not (_in_package(obj) and (
                inspect.isfunction(obj) or inspect.isclass(obj)
            )):
                continue
            sig = _callable_and_sig(obj)
            label = func.id
        elif isinstance(func, ast.Attribute):
            parts = _attr_parts(func)
            if parts is None:
                continue
            base_name, attrs = parts
            if base_name in ("self", "cls") and cls_name is not None:
                # Resolve through the class ONLY when the name is bound by
                # the method itself (scopes[0], the class-body-level def) as
                # its first parameter.  A nested function with its own
                # `self` parameter shadows the method's — resolving it
                # through the enclosing class would be a false positive.
                if not scopes:
                    continue
                binder = next(
                    (s for s in reversed(scopes) if _binds(s, base_name)),
                    None,
                )
                if binder is not scopes[0] or not _first_param_is(
                    binder, base_name
                ):
                    continue
                cls = getattr(module, cls_name, _MISSING)
                if not isinstance(cls, type) or len(attrs) != 1:
                    continue
                sig = _method_signature(cls, attrs[0])
                label = f"{cls_name}.{attrs[0]}"
            else:
                if locally_bound(base_name, scopes):
                    continue
                base = getattr(module, base_name, _MISSING)
                if base is _MISSING:
                    continue
                obj = _resolve_attr_chain(base, attrs)
                if obj is _MISSING or not callable(obj):
                    continue
                if not _in_package(obj):
                    continue
                if not (
                    inspect.isfunction(obj)
                    or inspect.isclass(obj)
                    or inspect.ismethod(obj)
                ):
                    continue
                sig = _callable_and_sig(obj)
                label = ".".join([base_name] + attrs)
        else:
            continue

        if sig is None:
            continue
        err = _check_call(sig, call)
        if err is not None:
            code = (
                "call-kwarg" if "keyword argument" in err else "call-arity"
            )
            findings.append(
                (
                    str(path),
                    call.lineno,
                    call.col_offset,
                    code,
                    f"call to {label}(): {err}",
                )
            )
    return findings


def check_annotations(module: ModuleType) -> List[Finding]:
    findings: List[Finding] = []
    mfile = getattr(module, "__file__", None) or "<module>"
    for name in sorted(vars(module)):
        obj = vars(module)[name]
        if getattr(obj, "__module__", None) != module.__name__:
            continue
        targets: List[Any] = []
        if inspect.isfunction(obj):
            targets = [obj]
        elif inspect.isclass(obj):
            targets = [obj] + [
                m
                for _, m in vars(obj).items()
                if inspect.isfunction(m)
            ]
        for t in targets:
            try:
                typing.get_type_hints(t)
            except Exception as e:
                line = 0
                try:
                    line = inspect.getsourcelines(t)[1]
                except (OSError, TypeError):
                    pass
                findings.append(
                    (
                        mfile,
                        line,
                        0,
                        "bad-annotation",
                        f"{module.__name__}.{getattr(t, '__qualname__', name)}: "
                        f"{type(e).__name__}: {e}",
                    )
                )
    return findings


def typecheck(paths: List[str]) -> List[Finding]:
    findings: List[Finding] = []
    seen_modules: Set[str] = set()
    for path in _iter_py(paths):
        mod_name = _module_name_for(path)
        if mod_name is None:
            continue
        try:
            module = importlib.import_module(mod_name)
        except Exception as e:  # pragma: no cover - import errors gate hard
            findings.append(
                (str(path), 0, 0, "import-error", f"{type(e).__name__}: {e}")
            )
            continue
        findings.extend(check_calls(path, module))
        if mod_name not in seen_modules:
            seen_modules.add(mod_name)
            findings.extend(check_annotations(module))
    return findings


def main(argv: List[str]) -> int:
    paths = argv or [str(REPO / PACKAGE)]
    findings = typecheck(paths)
    for path, line, col, code, msg in findings:
        print(f"{path}:{line}:{col} {code} {msg}")
    return 1 if findings else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
