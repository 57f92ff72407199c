"""Code-format gate — the JuliaFormatter analogue (``make format``).

The reference wires a formatter into its Makefile: ``scripts/formatter.jl``
runs JuliaFormatter over the tree and fails CI on drift
(``/root/reference/Makefile``, ``/root/reference/scripts/formatter.jl:1-10``).
This image ships no black/ruff and installing packages is forbidden, so this
module implements the formatting contract directly:

  * **long-line**       — lines must be <= 99 columns (string literals in
                          docstrings included; URLs are the only exemption).
  * **trailing-ws**     — no trailing whitespace.
  * **tab-indent**      — no tab characters in source.
  * **crlf**            — LF line endings only.
  * **eof-newline**     — file ends with exactly one newline.
  * **import-order**    — in the module's top import section, import groups
                          must appear stdlib -> third-party -> first-party
                          (``cortex_tpu``/relative), the coarse isort
                          contract; ``from __future__`` first.

Run: ``python tools/format.py [paths...]`` — exits non-zero with one
``path:line code message`` finding per line.  Gated by ``make lint`` /
``make format`` and ``tests/test_lint.py``.
"""

from __future__ import annotations

import ast
import re
import sys
from pathlib import Path
from typing import Iterator, List, Tuple

MAX_COLS = 99

_URL_RE = re.compile(r"https?://\S+")


def _url_overflows(line: str) -> bool:
    """True iff a URL token itself extends past the column limit — the only
    legitimate long-line exemption."""
    return any(m.end() > MAX_COLS for m in _URL_RE.finditer(line))

# Stdlib top-level module names actually imported anywhere in this repo —
# enough for the coarse grouping check without importlib probing.
STDLIB = {
    "__future__", "abc", "argparse", "ast", "builtins", "collections",
    "contextlib", "ctypes", "dataclasses", "enum", "functools", "gc", "glob",
    "hashlib", "html", "http", "importlib", "inspect", "io", "itertools",
    "json", "logging", "math", "multiprocessing", "os", "pathlib", "pickle",
    "platform", "queue", "random", "re", "shutil", "signal", "socket",
    "statistics", "string", "struct", "subprocess", "sys", "tempfile",
    "textwrap", "threading", "time", "timeit", "tracemalloc", "types",
    "typing", "unittest", "uuid", "warnings", "weakref", "zlib",
}

FIRST_PARTY = {"cortex_tpu", "conftest", "tools", "benchmarks"}

Finding = Tuple[Path, int, str, str]


def _group_of(node: ast.stmt) -> int:
    """0 = __future__, 1 = stdlib, 2 = third-party, 3 = first-party."""
    if isinstance(node, ast.ImportFrom):
        if node.level and node.level > 0:
            return 3
        root = (node.module or "").split(".")[0]
    else:
        assert isinstance(node, ast.Import)
        root = node.names[0].name.split(".")[0]
    if root == "__future__":
        return 0
    if root in FIRST_PARTY or root.startswith("test_"):
        return 3
    if root in STDLIB:
        return 1
    return 2


def _check_import_order(path: Path, tree: ast.Module) -> Iterator[Finding]:
    """Top import section = leading run of imports/docstring/assignments of
    dunders; groups must be non-decreasing in (future, stdlib, 3p, local)."""
    last_group = -1
    for node in tree.body:
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            g = _group_of(node)
            if g < last_group:
                names = ", ".join(
                    a.name for a in node.names
                ) if isinstance(node, ast.Import) else (node.module or ".")
                yield (
                    path,
                    node.lineno,
                    "import-order",
                    f"import of {names!r} out of group order "
                    "(stdlib -> third-party -> first-party)",
                )
            last_group = max(last_group, g)
        elif isinstance(node, (ast.Expr, ast.Assign, ast.If, ast.Try)):
            continue  # docstring / __all__ / guarded imports interleave
        else:
            break  # first real statement ends the import section


def _check_text(path: Path, text: str) -> Iterator[Finding]:
    if "\r" in text:
        yield (path, 1, "crlf", "CR line endings (LF only)")
    if text and (not text.endswith("\n") or text.endswith("\n\n")):
        yield (
            path,
            text.count("\n") + 1,
            "eof-newline",
            "file must end with exactly one newline",
        )
    for i, line in enumerate(text.split("\n"), 1):
        if len(line) > MAX_COLS and not _url_overflows(line):
            yield (path, i, "long-line", f"{len(line)} > {MAX_COLS} columns")
        if line != line.rstrip():
            yield (path, i, "trailing-ws", "trailing whitespace")
        if "\t" in line:
            yield (path, i, "tab-indent", "tab character in source")


def check_file(path: Path) -> List[Finding]:
    text = path.read_text()
    findings = list(_check_text(path, text))
    try:
        tree = ast.parse(text)
    except SyntaxError as e:  # pragma: no cover - lint.py reports these
        return findings + [(path, e.lineno or 1, "syntax", str(e.msg))]
    findings.extend(_check_import_order(path, tree))
    return findings


def default_paths() -> List[Path]:
    root = Path(__file__).resolve().parent.parent
    out: List[Path] = []
    for pat in (
        "cortex_tpu/**/*.py",
        "tests/*.py",
        "tools/*.py",
        "benchmarks/*.py",
        "bench.py",
        "__graft_entry__.py",
    ):
        out.extend(sorted(root.glob(pat)))
    return out


def main(argv: List[str]) -> int:
    paths = [Path(a) for a in argv] if argv else default_paths()
    findings: List[Finding] = []
    for p in paths:
        if p.is_dir():
            findings.extend(f for q in sorted(p.rglob("*.py")) for f in check_file(q))
        else:
            findings.extend(check_file(p))
    for path, line, code, msg in findings:
        print(f"{path}:{line}: {code} {msg}")
    return 1 if findings else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
