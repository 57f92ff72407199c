"""Generate the measured-numbers regions of the docs from BENCH_DETAIL.json.

Hand-maintained benchmark tables drift from the artifact they quote.  This
script makes drift structurally impossible: every numeric benchmark claim in
the docs lives inside a

    <!-- BEGIN bench-generated: NAME -->
    ...
    <!-- END bench-generated: NAME -->

region rendered HERE from the committed ``BENCH_DETAIL.json`` (written by
every ``python bench.py`` run on the card).  Without that artifact each
region says the numbers were not measured on the H100.  ``make docs-html``
regenerates the regions before building; ``tests/test_docs.py`` re-renders
them in memory and fails on any mismatch with the committed files.

Usage: python tools/gen_bench_docs.py [--check]
"""

from __future__ import annotations

import json
import pathlib
import re
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
DETAIL = REPO / "BENCH_DETAIL.json"

_REGION = re.compile(
    r"<!-- BEGIN bench-generated: (?P<name>[\w-]+) -->\n"
    r"(?P<body>.*?)"
    r"<!-- END bench-generated: (?P=name) -->",
    re.S,
)


def _med(stats) -> float:
    if isinstance(stats, dict):
        return stats.get("median_us")
    return None


def _fmt_us(v, nd=1) -> str:
    if v is None:
        return "n/a"
    if v >= 10_000:
        return f"{v / 1000:.1f} ms"
    return f"{v:.{nd}f} µs"


def _sci(v) -> str:
    if v is None:
        return "n/a"
    exp = 0
    while v >= 10:
        v /= 10.0
        exp += 1
    return f"{v:.1f}×10{''.join('⁰¹²³⁴⁵⁶⁷⁸⁹'[int(c)] for c in str(exp))}"


NOT_MEASURED = (
    "Not measured on the H100 yet: run `python bench.py` on the card.\n"
)


def _hmm_best(hmm, variant):
    return _med(hmm.get("per_vmp_iter_us", {}).get(variant))


def render_ladder(d) -> str:
    """The model-family table for docs/benchmarks.md."""
    det = d["detail"]
    lad = det["ladder"]
    best = det["best_path"]
    best_us = _med(det["sweep_device_us"][best])
    hmm, gmm = lad["hmm"], lad["gmm"]
    mv, hgf = lad["mv_lgssm"], lad["hgf"]
    hmm_scan = _hmm_best(hmm, "scan")
    hmm_pallas = _hmm_best(hmm, "pallas")
    hmm_best = min(v for v in (hmm_scan, hmm_pallas) if v is not None)
    gmm_us = _med(gmm["per_vmp_iter_us"])

    def mv_cells(key):
        row = mv[key]
        b = row["best_method"]
        return (
            f"{b} ({_fmt_us(_med(row['sweep_us'][b]))}); default "
            f"{row['default_method']} at "
            f"{row['default_vs_best_recursion']}× best recursion"
        )

    hgf_cfg = hgf["sweep_us"]
    lines = [
        "| Family | Config | Best path | Device time | Throughput |",
        "|---|---|---|---|---|",
        (
            f"| LGSSM BP smoothing | R=10k, T=100 | {best} | "
            f"{_fmt_us(best_us)}/sweep | "
            f"{_sci(d['value'])} msg updates/s |"
        ),
        (
            f"| HMM + Dirichlet VMP | R=4096, T=64, K=4 | "
            f"{'pallas' if (hmm_pallas or 1e9) < (hmm_scan or 1e9) else 'scan'}"
            f" (scan {_fmt_us(hmm_scan)}, pallas {_fmt_us(hmm_pallas)}"
            + (
                f", ratio {hmm['ratio_scan_over_pallas']}×"
                if hmm.get("ratio_scan_over_pallas")
                else ""
            )
            + f") | {_fmt_us(hmm_best)}/VMP iter | "
            f"{_sci(hmm['msg_updates_per_s'])} msg updates/s |"
        ),
        (
            f"| GMM structured VMP | R={gmm['replicas']}, N={gmm['N']}, "
            f"K={gmm['K']} | jitted batched VMP "
            f"({gmm['binding_resource'].split(':')[0]}) | "
            f"{_fmt_us(gmm_us)}/VMP iter | "
            f"{_sci(gmm['resp_updates_per_s'])} resp updates/s |"
        ),
        (
            f"| MvLGSSM smoothing | R={mv['d4']['replicas']}, T=100, d=4 | "
            f"{mv_cells('d4')} | "
            f"{_fmt_us(_med(mv['d4']['sweep_us'][mv['d4']['best_method']]))}/sweep"
            f" | {mv['d4']['achieved_tflops']} achieved TFLOP/s |"
        ),
        (
            f"| MvLGSSM smoothing | R={mv['d16']['replicas']}, T=100, d=16 | "
            f"{mv_cells('d16')} | "
            f"{_fmt_us(_med(mv['d16']['sweep_us'][mv['d16']['best_method']]))}/sweep"
            f" | {mv['d16']['achieved_tflops']} achieved TFLOP/s |"
        ),
        (
            f"| Streaming HGF | R={hgf['replicas']}, T={hgf['T']} | pallas, "
            f"tracks opt-in | "
            f"{_fmt_us(_med(hgf_cfg['pallas']))} all-5-track / "
            f"{_fmt_us(_med(hgf_cfg['pallas_filter_only']))} filtering-only "
            f"(scan {_fmt_us(_med(hgf_cfg['scan']))}) | "
            f"{_sci(hgf['obs_per_s'])} obs/s filtering, "
            f"{hgf['pct_of_compute_floor']}% of the measured compute floor |"
        ),
        "",
        (
            f"Per-call device-bound times (median over rounds of "
            f"back-to-back calls) on {det['hardware']['card']}.  Spreads: "
            f"`BENCH_DETAIL.json`."
        ),
    ]
    return "\n".join(lines) + "\n"


def render_mv_methods(d) -> str:
    """MvLGSSM method-selection numbers for docs/models.md."""
    mv = d["detail"]["ladder"]["mv_lgssm"]
    r4, r16 = mv["d4"], mv["d16"]

    def us(row, meth):
        return _fmt_us(_med(row["sweep_us"].get(meth, {})))

    return (
        f"Measured on {d['detail']['hardware']['card']} "
        f"(BENCH_DETAIL.json `ladder.mv_lgssm`), (R={r4['replicas']}, T=100, d=4): matmul "
        f"{us(r4, 'matmul')}, matmul_bf16 {us(r4, 'matmul_bf16')}, blocked "
        f"{us(r4, 'blocked')}, scan {us(r4, 'scan')} per sweep; "
        f"(R={r16['replicas']}, T=100, d=16): matmul {us(r16, 'matmul')}, "
        f"blocked {us(r16, 'blocked')}, scan {us(r16, 'scan')}.  "
        f"`method=\"auto\"` (the default) picks {r4['default_method']} at "
        f"d=4 and {r16['default_method']} at d=16 — "
        f"{r4['default_vs_best_recursion']}× and "
        f"{r16['default_vs_best_recursion']}× the best measured "
        f"exact-recursion path respectively.\n"
    )


def render_structured(d) -> str:
    """Structured-VMP warm/steady numbers for docs/compiled.md."""
    st = d["detail"]["generic_structured"]
    return (
        f"sweep {_fmt_us(st['warm_start_sweep_us'])} warm start, then "
        f"{_fmt_us(st['steady_iter_us'])} per steady Jacobi iteration at "
        f"{st['replicas'] // 1000}k replicas "
        f"({_sci(st['joint_updates_per_s'])} joint-marginal updates/s; "
        f"BENCH_DETAIL.json `generic_structured`).  The warm start runs "
        f"the chain-lowered 14-segment plan (one length-98 `lax.scan` + "
        f"the segment-tree product levels), not the raw 207-phase "
        f"schedule.\n"
    )


def render_bf16_speed(d) -> str:
    """bf16-edge speed bullet for docs/precision.md."""
    det = d["detail"]
    p = det["sweep_device_us"]
    mv = det["ladder"]["mv_lgssm"]
    mm, mmb = _med(p["matmul"]), _med(p["matmul_bf16"])
    s100 = det.get("sweep_device_us_100k_replicas", {})
    mm1, mmb1 = _med(s100.get("matmul")), _med(s100.get("matmul_bf16"))
    ratio = f"{mm / mmb:.2f}×" if mm and mmb else "n/a"
    r100 = f"{mm1 / mmb1:.2f}×" if mm1 and mmb1 else "n/a"
    return (
        f"- **Speed** (BENCH_DETAIL.json): the flagship "
        f"scalar sweep's bf16 edge runs {ratio} the f32 matmul at 10k "
        f"replicas ({_fmt_us(mmb)} vs {_fmt_us(mm)}) and {r100} at 100k "
        f"({_fmt_us(mmb1)} vs {_fmt_us(mm1)}); the mv bf16-edge matmul "
        f"reaches {mv['d16']['mfu_pct_bf16_edge_path']}% MFU at d=16 "
        f"({mv['d4']['mfu_pct_bf16_edge_path']}% at d=4) against the bf16 "
        f"spec peak.\n"
    )


def render_weak_scaling(ctx) -> str:
    """Weak-scaling slowdown table for docs/scaling.md (from
    SCALING_r05.json)."""
    paths = ctx["paths"]
    rows_by = {
        "replica-sharded LGSSM": ("replica_sharded_lgssm", None),
        "time-sharded scalar": ("time_sharded_scalar", None),
        "time-sharded mv (d=4)": ("time_sharded_mv_d4", None),
        "pipelined (M=S)": ("pipelined", lambda r: r["n_micro"] == r["devices"]),
        "pipelined (M=4S)": (
            "pipelined",
            lambda r: r["n_micro"] == 4 * r["devices"],
        ),
    }
    lines = [
        "| Path | n=2 | n=4 | n=8 | collective fraction (n=2, 1:1 cores) |",
        "|---|---|---|---|---|",
    ]
    for label, (key, pred) in rows_by.items():
        rows = [r for r in paths[key]["rows"] if pred is None or pred(r)]
        by_n = {r["devices"]: r for r in rows}

        def slow(n):
            r = by_n.get(n)
            return f"{r['slowdown_vs_embarrassing']:.2f}" if r else "—"

        cf = by_n.get(2, {}).get("collective_fraction")
        cf_s = f"{cf:.2f}" if cf is not None else "— (no collectives)"
        lines.append(
            f"| {label} | {slow(2)} | {slow(4)} | {slow(8)} | {cf_s} |"
        )
    return "\n".join(lines) + "\n"


RENDERERS = {
    "ladder": render_ladder,
    "mv-methods": render_mv_methods,
    "structured-steady": render_structured,
    "bf16-speed": render_bf16_speed,
}
SCALING_RENDERERS = {"weak-scaling": render_weak_scaling}

DOC_FILES = (
    "docs/benchmarks.md",
    "docs/models.md",
    "docs/compiled.md",
    "docs/precision.md",
    "docs/scaling.md",
)


def rendered_files(detail=None, scaling=None) -> dict:
    """{relative path: new text} for every doc containing generated
    regions; ``detail=None`` renders the not-measured text."""
    if scaling is None and (REPO / "SCALING_r05.json").exists():
        scaling = json.loads((REPO / "SCALING_r05.json").read_text())
    out = {}
    for rel in DOC_FILES:
        path = REPO / rel
        text = path.read_text()

        def sub(mo):
            name = mo.group("name")
            if name in RENDERERS:
                body = NOT_MEASURED if detail is None else RENDERERS[name](detail)
            elif name in SCALING_RENDERERS and scaling is not None:
                body = SCALING_RENDERERS[name](scaling)
            elif name in SCALING_RENDERERS:
                return mo.group(0)  # artifact absent: leave untouched
            else:
                raise SystemExit(f"{rel}: unknown generated region {name!r}")
            return (
                f"<!-- BEGIN bench-generated: {name} -->\n"
                f"{body}"
                f"<!-- END bench-generated: {name} -->"
            )

        new, n = _REGION.subn(sub, text)
        if n:
            out[rel] = new
    return out


def load_detail():
    """The committed ``BENCH_DETAIL.json``, or None when there is none."""
    return json.loads(DETAIL.read_text()) if DETAIL.exists() else None


def main(argv) -> int:
    check = "--check" in argv
    changed = []
    for rel, new in rendered_files(load_detail()).items():
        path = REPO / rel
        if path.read_text() != new:
            changed.append(rel)
            if not check:
                path.write_text(new)
    if check and changed:
        print(f"bench-generated regions stale: {changed}", file=sys.stderr)
        return 1
    print(f"bench-generated regions {'checked' if check else 'written'}: "
          f"{changed or 'all up to date'}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
