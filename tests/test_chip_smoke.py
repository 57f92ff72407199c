"""``chip_smoke.py`` at tiny sizes on the CPU: every phase runs (Pallas
kernels in interpret mode, the four-card phases on virtual devices) and
passes its own checks; ``main()`` refuses to run without a GPU."""

import importlib.util
import pathlib

import numpy as np
import pytest

import jax

_PATH = pathlib.Path(__file__).resolve().parents[1] / "chip_smoke.py"
_spec = importlib.util.spec_from_file_location("chip_smoke", _PATH)
cs = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(cs)

PHASES = {
    "lgssm": (cs.phase_lgssm, dict(R=40, T=30, interpret=True)),
    "mv_lgssm_d4": (cs.phase_mv_lgssm, dict(R=8, T=20, d=4)),
    "mv_lgssm_d16": (cs.phase_mv_lgssm, dict(R=4, T=12, d=16)),
    "compiled_bp": (cs.phase_compiled_bp, dict(R=16, T=12)),
    "compiled_vmp": (cs.phase_compiled_vmp, dict(R=16, n=12, iters=3)),
    "hmm_vmp": (cs.phase_hmm, dict(R=32, T=16, K=4, M=8, iters=3,
                                   interpret=True)),
    "hmm_kernel_k4": (cs.phase_hmm_kernel, dict(R=32, T=16, K=4,
                                                interpret=True)),
    "hmm_kernel_k16": (cs.phase_hmm_kernel, dict(R=16, T=8, K=16,
                                                 interpret=True)),
    "hgf": (cs.phase_hgf, dict(R=40, T=24, interpret=True)),
    "serve": (cs.phase_serve, dict(R=64, T=16, batches=(10, 37, 64))),
}

FOUR_CARD = {
    "replica_sharded": (cs.phase_replica_sharded, dict(R=64, T=16)),
    "time_sharded": (cs.phase_time_sharded, dict(R=8, T=64)),
    "mv_time_sharded": (cs.phase_mv_time_sharded, dict(R=4, T=32, d=4)),
}


def _assert_passed(checks):
    assert checks
    failed = [c for c in checks if not c["ok"]]
    assert not failed, failed
    for c in checks:
        assert c["tol"] > 0 and c["why"]


@pytest.mark.parametrize("name", sorted(PHASES))
def test_phase_passes_at_tiny_size(name):
    fn, kwargs = PHASES[name]
    _assert_passed(fn(**kwargs))


@pytest.mark.parametrize("name", sorted(FOUR_CARD))
def test_four_card_phase_passes_on_virtual_devices(name):
    fn, kwargs = FOUR_CARD[name]
    devices = jax.devices()[:4]
    assert len(devices) == 4
    _assert_passed(fn(devices=devices, **kwargs))


def test_phase_table_sizes_are_the_documented_ones():
    """The one-card run covers the issue's widths: 10k x 100 and 100k x
    1000 scalar sweeps, d=4 and d=16, the HMM and HGF bench shapes."""
    sizes = {label: kw for label, _, kw in cs.ONE_CARD}
    assert sizes["lgssm 100k x 1000"] == dict(R=100_000, T=1000)
    assert sizes["hgf"] == dict(R=65_536, T=256)
    assert {kw["K"] for label, kw in sizes.items() if "hmm kernel" in label} \
        == {4, 8, 16}
    four = {label: kw for label, _, kw in cs.four_card_phases(["d"] * 4)}
    assert four["time sharded"]["T"] % 4 == 0


def test_compare_flags_errors_shapes_and_nonfinite():
    ok = cs.compare("x", [1.0, 2.0], [1.0, 2.0 + 1e-7], 1e-6, "why")
    assert ok["ok"] and ok["max_abs"] < 1e-6
    assert not cs.compare("x", [1.0, 2.5], [1.0, 2.0], 1e-3, "why")["ok"]
    assert not cs.compare("x", [1.0], [1.0, 2.0], 1e-3, "why")["ok"]
    assert not cs.compare("x", [np.nan], [1.0], 1e-3, "why")["ok"]


def test_run_phases_reports_a_raising_phase_as_failure():
    lines = []

    def boom():
        raise RuntimeError("nope")

    assert not cs.run_phases([("boom", boom, {})], emit=lines.append)
    assert any("FAIL" in line and "nope" in line for line in lines)


def test_main_refuses_the_cpu(capsys):
    assert cs.main([]) != 0
    out = capsys.readouterr()
    assert out.out == ""
    assert "needs a GPU" in out.err
