"""Doc pages are executable specs (reference parity: `@example` blocks with
embedded tests run in CI, `.github/workflows/CI.yml:79-86`): every python
code block in docs/*.md runs here, sharing one namespace per page."""

import os
import re

import pytest

DOCS = os.path.join(os.path.dirname(__file__), "..", "docs")

_BLOCK = re.compile(r"```python\n(.*?)```", re.DOTALL)


def _pages():
    for name in sorted(os.listdir(DOCS)):
        if name.endswith(".md"):
            yield name


@pytest.mark.parametrize("page", list(_pages()))
def test_doc_page_examples_run(page):
    with open(os.path.join(DOCS, page)) as fh:
        text = fh.read()
    blocks = _BLOCK.findall(text)
    assert blocks, f"{page} has no python examples"
    namespace = {}
    for i, block in enumerate(blocks):
        try:
            exec(compile(block, f"{page}[block {i}]", "exec"), namespace)
        except Exception as e:  # pragma: no cover
            pytest.fail(f"{page} block {i} failed: {type(e).__name__}: {e}")


def test_docs_html_build(tmp_path, monkeypatch):
    """The rendered-docs build (tools/docs_build.py, Documenter analogue)
    must produce one HTML page per doc page with nav + structural markup."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "docs_build", repo / "tools" / "docs_build.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "OUT", tmp_path)
    out = mod.build()
    pages = sorted(p.name for p in out.glob("*.html"))
    md = sorted(p.stem for p in (repo / "docs").glob("*.md"))
    assert sorted(p[:-5] for p in pages) == md
    bench_html = (out / "benchmarks.html").read_text()
    assert "<nav>" in bench_html and "<table>" in bench_html
    assert "<pre><code>" in bench_html
    # .md cross-links rewritten to .html
    assert ".md)" not in bench_html


def test_bench_generated_regions_match_artifact():
    """Every numeric benchmark claim inside a bench-generated region must
    equal what tools/gen_bench_docs.py renders from the committed
    BENCH_DETAIL.json — or, with no artifact, the not-measured text."""
    import importlib.util
    import pathlib

    repo = pathlib.Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location(
        "gen_bench_docs", repo / "tools" / "gen_bench_docs.py"
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    detail = mod.load_detail()
    rendered = mod.rendered_files(detail)
    assert rendered, "no bench-generated regions found in docs/"
    stale = [
        rel for rel, new in rendered.items()
        if (repo / rel).read_text() != new
    ]
    assert not stale, (
        f"docs drifted from BENCH_DETAIL.json in {stale}; run "
        "`python tools/gen_bench_docs.py`"
    )
    if detail is None:
        for rel in rendered:
            text = (repo / rel).read_text()
            for mo in mod._REGION.finditer(text):
                if mo.group("name") in mod.RENDERERS:
                    assert mo.group("body") == mod.NOT_MEASURED, (rel, mo)
