"""HGF streaming-filter tests: tracking, volatility detection, chunked
streaming equivalence, replica sharding."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cortex_tpu.models.hgf import HGF, HGFState
from cortex_tpu.parallel import make_mesh, shard_replicas
from cortex_tpu.parallel.streaming import StreamingSession, stream_filter


def test_tracks_slowly_varying_signal():
    rng = np.random.default_rng(0)
    T = 300
    x = np.sin(np.linspace(0, 6 * np.pi, T)) * 2.0
    u = x + 0.1 * rng.normal(size=T)
    hgf = HGF(pi_u=100.0, omega=-1.0)
    _, traj = hgf.filter(jnp.asarray(u))
    err = np.abs(np.asarray(traj.mu1[50:]) - x[50:])
    assert err.mean() < 0.25


def test_volatility_level_reacts_to_regime_change():
    rng = np.random.default_rng(1)
    # Quiet regime then volatile regime.
    quiet = 0.05 * rng.normal(size=300)
    loud = np.cumsum(1.0 * rng.normal(size=300))
    u = np.concatenate([quiet, loud])
    hgf = HGF(pi_u=100.0)
    _, traj = hgf.filter(jnp.asarray(u))
    mu2 = np.asarray(traj.mu2)
    # Posterior volatility belief rises after the regime change.
    assert mu2[550:].mean() > mu2[250:300].mean() + 0.5


def test_step_and_filter_agree():
    rng = np.random.default_rng(2)
    u = rng.normal(size=20).astype(np.float32)
    hgf = HGF()
    state = hgf.init_state()
    for t in range(20):
        state, _ = hgf.step(state, jnp.asarray(u[t]))
    final, _ = hgf.filter(jnp.asarray(u))
    for got, want in zip(state, final):
        assert float(got) == pytest.approx(float(want), rel=1e-5)


def test_precisions_stay_positive():
    rng = np.random.default_rng(3)
    u = (10.0 * rng.normal(size=500)).astype(np.float32)  # adversarially noisy
    hgf = HGF(pi_u=1000.0, kappa=2.0)
    _, traj = hgf.filter(jnp.asarray(u))
    assert np.all(np.asarray(traj.pi1) > 0)
    assert np.all(np.asarray(traj.pi2) > 0)
    assert np.all(np.isfinite(np.asarray(traj.mu2)))


def test_chunked_streaming_matches_batch_filter():
    rng = np.random.default_rng(4)
    u = rng.normal(size=(8, 128)).astype(np.float32)  # 8 replicas
    hgf = HGF()

    batch_final, _ = hgf.filter(jnp.asarray(u))

    chunk_step = jax.jit(lambda st, chunk: hgf.filter(chunk, state=st))
    chunks = [u[:, i : i + 32] for i in range(0, 128, 32)]
    stream_final, outs = stream_filter(chunk_step, chunks, hgf.init_state((8,)))
    assert len(outs) == 4
    for got, want in zip(stream_final, batch_final):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


def test_streaming_session_matches_batch_filter():
    rng = np.random.default_rng(5)
    u = rng.normal(size=(4, 96)).astype(np.float32)
    hgf = HGF()
    batch_final, _ = hgf.filter(jnp.asarray(u))

    session = StreamingSession(
        jax.jit(lambda st, chunk: hgf.filter(chunk, state=st)),
        hgf.init_state((4,)),
    )
    for i in range(0, 96, 16):
        session.push(u[:, i : i + 16])
    final = session.flush()
    assert len(session.outputs) == 6
    for got, want in zip(final, batch_final):
        np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5)


def test_replica_sharded_streaming():
    """Online filtering over mesh-sharded replicas (the BASELINE config)."""
    rng = np.random.default_rng(6)
    u = rng.normal(size=(64, 50)).astype(np.float32)
    hgf = HGF()
    mesh = make_mesh()

    u_sharded = shard_replicas(jnp.asarray(u), mesh)
    state = jax.tree_util.tree_map(
        lambda a: shard_replicas(a, mesh), hgf.init_state((64,))
    )
    step = jax.jit(lambda st, chunk: hgf.filter(chunk, state=st))
    final, traj = step(state, u_sharded)

    expected, _ = hgf.filter(jnp.asarray(u))
    np.testing.assert_allclose(
        np.asarray(final.mu1), np.asarray(expected.mu1), rtol=1e-5
    )


# -- binary HGF (3-level) ----------------------------------------------------


def test_binary_hgf_tracks_reward_probability():
    from cortex_tpu.models import BinaryHGF

    rng = np.random.default_rng(0)
    # Reward probability switches 0.85 -> 0.15 -> 0.85.
    ps = np.concatenate([np.full(120, 0.85), np.full(120, 0.15), np.full(120, 0.85)])
    u = (rng.random(360) < ps).astype(np.float32)

    hgf = BinaryHGF(omega=-2.0)
    final, traj = hgf.filter(jnp.asarray(u))
    p_hat = np.asarray(traj.p_hat)
    # After settling, predictions reflect each block's probability.
    assert p_hat[80:120].mean() > 0.6
    assert p_hat[200:240].mean() < 0.4
    assert p_hat[320:].mean() > 0.6
    assert np.all(np.isfinite(np.asarray(traj.mu3)))


def test_binary_hgf_volatility_rises_at_switches():
    from cortex_tpu.models import BinaryHGF

    rng = np.random.default_rng(1)
    stable = (rng.random(200) < 0.9).astype(np.float32)
    volatile = (rng.random(200) < np.where(np.arange(200) % 40 < 20, 0.9, 0.1)).astype(
        np.float32
    )
    hgf = BinaryHGF()
    _, t_stable = hgf.filter(jnp.asarray(stable))
    _, t_vol = hgf.filter(jnp.asarray(volatile))
    assert float(np.asarray(t_vol.mu3)[100:].mean()) > float(
        np.asarray(t_stable.mu3)[100:].mean()
    )


def test_binary_hgf_batched_and_step_agree():
    from cortex_tpu.models import BinaryHGF

    rng = np.random.default_rng(2)
    u = (rng.random((5, 30)) < 0.7).astype(np.float32)
    hgf = BinaryHGF()
    final, _ = hgf.filter(jnp.asarray(u))
    assert final.mu2.shape == (5,)

    state = hgf.init_state(())
    for t in range(30):
        state, _ = hgf.step(state, jnp.asarray(u[2, t]))
    assert float(state.mu2) == pytest.approx(float(final.mu2[2]), rel=1e-5)


def test_hgf_pallas_filter_matches_scan():
    """The fused Triton kernel (ops/pallas_hgf.py) must reproduce the
    lax.scan filter exactly (interpret mode on CPU), including the guard
    semantics, across a non-tile-aligned replica count."""
    import numpy as np
    import jax.numpy as jnp

    from cortex_tpu.models import HGF

    hgf = HGF()
    u = jnp.asarray(
        np.random.default_rng(3).normal(size=(33, 50)).cumsum(-1) * 0.2,
        jnp.float32,
    )
    fs, ts = hgf.filter(u)
    fp, tp = hgf.filter(u, method="pallas", interpret=True)
    for name in ("mu1", "pi1", "mu2", "pi2", "prediction_error"):
        np.testing.assert_allclose(
            np.asarray(getattr(ts, name)),
            np.asarray(getattr(tp, name)),
            atol=1e-5,
            err_msg=name,
        )
    np.testing.assert_allclose(np.asarray(fs.mu2), np.asarray(fp.mu2), atol=1e-5)


def test_hgf_pallas_rejects_bad_shapes():
    import jax.numpy as jnp
    import pytest

    from cortex_tpu.models import HGF

    hgf = HGF()
    with pytest.raises(ValueError, match="pallas"):
        hgf.filter(jnp.zeros((4, 5, 6)), method="pallas")
    with pytest.raises(ValueError, match="unknown method"):
        hgf.filter(jnp.zeros((4, 5)), method="nope")


def test_hgf_pallas_track_selection():
    """Opt-in trajectory tracks: finals always exact,
    unrequested tracks come back as None, requested subset matches scan."""
    import numpy as np
    import jax.numpy as jnp

    from cortex_tpu.models import HGF

    hgf = HGF()
    u = jnp.asarray(
        np.random.default_rng(5).normal(size=(17, 40)).cumsum(-1) * 0.3,
        jnp.float32,
    )
    fs, ts = hgf.filter(u)  # full scan reference
    # Filtering-only: no tracks at all.
    f0, t0 = hgf.filter(u, method="pallas", tracks=(), interpret=True)
    for name in ("mu1", "pi1", "mu2", "pi2"):
        np.testing.assert_allclose(
            np.asarray(getattr(f0, name)),
            np.asarray(getattr(fs, name)),
            atol=1e-5,
            err_msg=name,
        )
    assert all(v is None for v in t0)
    # Subset through BOTH methods.
    for method in ("scan", "pallas"):
        f2, t2 = hgf.filter(u, method=method, tracks=("mu1", "mu2"),
                            interpret=True)
        np.testing.assert_allclose(
            np.asarray(t2.mu1), np.asarray(ts.mu1), atol=1e-5
        )
        np.testing.assert_allclose(
            np.asarray(t2.mu2), np.asarray(ts.mu2), atol=1e-5
        )
        assert t2.pi1 is None and t2.pi2 is None and t2.prediction_error is None


def test_hgf_pallas_bf16_track_io():
    """bf16 trajectory writes: half the output traffic, bf16-level accuracy;
    the recursion itself stays f32 (finals remain f32-exact)."""
    import numpy as np
    import jax.numpy as jnp

    from cortex_tpu.ops.pallas_hgf import hgf_filter_pallas

    u = jnp.asarray(
        np.random.default_rng(6).normal(size=(9, 32)).cumsum(-1) * 0.2,
        jnp.float32,
    )
    fin32, (mu1_32,) = hgf_filter_pallas(u, tracks=("mu1",), interpret=True)
    fin16, (mu1_16,) = hgf_filter_pallas(
        u, tracks=("mu1",), track_dtype=jnp.bfloat16, interpret=True
    )
    assert mu1_16.dtype == jnp.bfloat16
    np.testing.assert_allclose(
        np.asarray(fin16[0]), np.asarray(fin32[0]), atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(mu1_16, np.float32), np.asarray(mu1_32), atol=2e-2, rtol=1e-2
    )


def test_hgf_pallas_guards():
    import jax.numpy as jnp
    import pytest

    from cortex_tpu.ops.pallas_hgf import hgf_filter_pallas

    with pytest.raises(ValueError, match="unknown tracks"):
        hgf_filter_pallas(jnp.zeros((4, 8)), tracks=("mu1", "bogus"),
                          interpret=True)
    with pytest.raises(ValueError, match="power of two"):
        hgf_filter_pallas(jnp.zeros((4, 8)), tile=48, interpret=True)
    # Traced parameters must fail loudly, pointing at method='scan'.
    import jax

    def f(om):
        return hgf_filter_pallas(jnp.zeros((4, 8)), omega=om,
                                 interpret=True)[0][0]

    with pytest.raises(ValueError, match="scan"):
        jax.jit(f)(jnp.float32(-2.0))


@pytest.mark.parametrize("tracks", [(), ("mu2",), ("delta1", "mu1", "pi2")])
def test_hgf_pallas_replica_padding_and_track_layouts(tracks):
    """Replica counts off the block are padded and trimmed; filter-only runs
    the natural (R, T) layout, requested tracks the time-major one, and both
    match the scan exactly (order of requested tracks preserved)."""
    import numpy as np

    from cortex_tpu.models import HGF
    from cortex_tpu.ops.pallas_hgf import ALL_TRACKS, hgf_filter_pallas

    u = jnp.asarray(
        np.random.default_rng(0).normal(size=(37, 48)).cumsum(-1) * 0.1,
        jnp.float32,
    )
    finals, values = hgf_filter_pallas(u, tracks=tracks, tile=32,
                                       interpret=True)
    ref_final, ref_traj = HGF().filter(u, method="scan")
    assert len(values) == len(tracks)
    for got, want in zip(finals, ref_final):
        assert got.shape == (37,)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
    for name, got in zip(tracks, values):
        want = ref_traj[ALL_TRACKS.index(name)]
        assert got.shape == u.shape
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-5, atol=1e-5)
