"""Pallas kernel tests.  On the CPU the kernels run in interpret mode
(``interpret=True``) against the scan formulations, and their GPU lowering
(Pallas -> Triton IR) is checked without a card; tests marked ``gpu`` run the
compiled kernels on an NVIDIA GPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cortex_tpu.models import HGF
from cortex_tpu.ops import lgssm_smooth_scan
from cortex_tpu.ops._triton import next_pow2, replica_tile
from cortex_tpu.ops.hmm import hmm_forward_backward
from cortex_tpu.ops.pallas_hgf import ALL_TRACKS, hgf_filter_pallas
from cortex_tpu.ops.pallas_hmm import (
    hmm_forward_backward_counts_pallas,
    hmm_forward_backward_pallas,
)
from cortex_tpu.ops.pallas_kernels import (
    lgssm_smooth_pallas,
    smoother_coefficients,
)


def test_lgssm_pallas_matches_scan():
    rng = np.random.default_rng(0)
    y = jnp.asarray(rng.normal(size=(40, 32)).cumsum(axis=-1), dtype=jnp.float32)
    a = lgssm_smooth_pallas(y, tile=16, interpret=True)
    b = lgssm_smooth_scan(y)
    np.testing.assert_allclose(
        np.asarray(a.mean), np.asarray(b.mean), rtol=1e-4, atol=1e-4
    )
    np.testing.assert_allclose(
        np.asarray(a.variance), np.asarray(b.variance), rtol=1e-4, atol=1e-4
    )


def test_lgssm_pallas_nondefault_params_and_padding():
    rng = np.random.default_rng(1)
    # 21 replicas with tile 16 exercises the padding path.
    y = jnp.asarray(rng.normal(size=(21, 24)).cumsum(axis=-1), dtype=jnp.float32)
    a = lgssm_smooth_pallas(y, A=0.9, Q=0.5, H=2.0, R=0.7, tile=16,
                            interpret=True)
    b = lgssm_smooth_scan(y, A=0.9, Q=0.5, H=2.0, R=0.7)
    assert a.mean.shape == y.shape and a.variance.shape == y.shape
    np.testing.assert_allclose(
        np.asarray(a.mean), np.asarray(b.mean), rtol=1e-3, atol=1e-3
    )


@pytest.mark.parametrize("T", [1, 2, 7])
def test_lgssm_pallas_short_chains(T):
    """T=1 (no recursion) and T=2 (one step each way) are edge cases of the
    in-kernel loops."""
    y = jnp.asarray(np.random.default_rng(T).normal(size=(5, T)), jnp.float32)
    a = lgssm_smooth_pallas(y, interpret=True)
    b = lgssm_smooth_scan(y)
    np.testing.assert_allclose(np.asarray(a.mean), np.asarray(b.mean),
                               atol=1e-5)


def test_smoother_coefficients_give_the_scan_variances():
    """The kernel's host-side precisions are the scan's data-independent
    marginal variances."""
    cf, cb, var = smoother_coefficients(30, 0.9, 0.5, 2.0, 0.7)
    ref = lgssm_smooth_scan(jnp.zeros((1, 30)), 0.9, 0.5, 2.0, 0.7)
    np.testing.assert_allclose(var, np.asarray(ref.variance[0]), rtol=1e-5)
    assert cf[0] == 0.0 and cb[-1] == 0.0


def test_hmm_pallas_matches_log_scan():
    rng = np.random.default_rng(2)
    R_, T, K = 12, 15, 4
    lik = (rng.random((R_, T, K)) + 0.1).astype(np.float32)
    A = (rng.random((K, K)) + 0.2).astype(np.float32)
    A /= A.sum(1, keepdims=True)
    pi = np.full(K, 1 / K, dtype=np.float32)

    out = hmm_forward_backward_pallas(
        jnp.asarray(lik), jnp.asarray(A), jnp.asarray(pi), tile=8,
        interpret=True,
    )
    ref = hmm_forward_backward(
        jnp.log(jnp.asarray(lik)), jnp.log(jnp.asarray(A)), jnp.log(jnp.asarray(pi))
    )
    np.testing.assert_allclose(
        np.asarray(out.gamma), np.exp(np.asarray(ref.log_gamma)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.log_evidence), np.asarray(ref.log_evidence), rtol=1e-5
    )


def test_hmm_pallas_gamma_normalized():
    rng = np.random.default_rng(3)
    lik = (rng.random((4, 10, 3)) + 0.05).astype(np.float32)
    A = np.full((3, 3), 1 / 3, dtype=np.float32)
    pi = np.full(3, 1 / 3, dtype=np.float32)
    out = hmm_forward_backward_pallas(
        jnp.asarray(lik), jnp.asarray(A), jnp.asarray(pi), tile=4,
        interpret=True,
    )
    np.testing.assert_allclose(np.asarray(out.gamma).sum(-1), 1.0, rtol=1e-5)


def test_hmm_counts_pallas_matches_log_scan():
    rng = np.random.default_rng(4)
    R_, T, K = 8, 12, 4
    lik = (rng.random((R_, T, K)) + 0.1).astype(np.float32)
    A = (rng.random((K, K)) + 0.2).astype(np.float32)
    A /= A.sum(1, keepdims=True)
    pi = np.full(K, 1 / K, dtype=np.float32)

    out = hmm_forward_backward_counts_pallas(
        jnp.asarray(lik), jnp.asarray(A), jnp.asarray(pi), tile=4,
        interpret=True,
    )
    ref = hmm_forward_backward(
        jnp.log(jnp.asarray(lik)), jnp.log(jnp.asarray(A)), jnp.log(jnp.asarray(pi))
    )
    np.testing.assert_allclose(
        np.asarray(out.gamma), np.exp(np.asarray(ref.log_gamma)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.xi_sum), np.exp(np.asarray(ref.log_xi_sum)), atol=1e-5
    )
    np.testing.assert_allclose(
        np.asarray(out.log_evidence), np.asarray(ref.log_evidence), rtol=1e-5
    )
    # xi_sum rows sum to T-1 total mass.
    np.testing.assert_allclose(np.asarray(out.xi_sum).sum((-2, -1)), T - 1, rtol=1e-4)


@pytest.mark.parametrize("K", [2, 3, 5, 16])
def test_hmm_counts_pallas_pads_states_to_power_of_two(K):
    """K is padded to a power of two with zero-mass states (K=16 takes the
    float32-dot branch); outputs come back at the caller's K and R."""
    rng = np.random.default_rng(K)
    R_, T = 19, 9
    lik = jnp.asarray(rng.random((R_, T, K)) + 0.1, jnp.float32)
    A = rng.random((K, K)) + 0.2
    A = jnp.asarray(A / A.sum(1, keepdims=True), jnp.float32)
    pi = jnp.full((K,), 1.0 / K, jnp.float32)
    out = hmm_forward_backward_counts_pallas(lik, A, pi, interpret=True)
    ref = hmm_forward_backward(jnp.log(lik), jnp.log(A), jnp.log(pi))
    assert out.gamma.shape == (R_, T, K) and out.xi_sum.shape == (R_, K, K)
    np.testing.assert_allclose(np.asarray(out.gamma),
                               np.exp(np.asarray(ref.log_gamma)), atol=1e-5)
    np.testing.assert_allclose(np.asarray(out.xi_sum),
                               np.exp(np.asarray(ref.log_xi_sum)), atol=1e-4)


@pytest.mark.parametrize(
    "n, lo, hi, want",
    [(10, 32, 128, 32), (10_000, 32, 128, 32), (100_000, 32, 128, 128),
     (4096, 16, 256, 16), (1_000_000, 16, 64, 64)],
)
def test_replica_tile(n, lo, hi, want):
    tile = replica_tile(n, lo=lo, hi=hi)
    assert tile == want and tile & (tile - 1) == 0


def test_next_pow2():
    assert [next_pow2(k) for k in (1, 2, 3, 4, 5, 16, 17)] == [1, 2, 4, 4, 8, 16, 32]


def _lgssm(interpret):
    y = jnp.ones((4, 8))
    return lgssm_smooth_pallas(y, interpret=interpret)


def _hmm(interpret):
    return hmm_forward_backward_pallas(
        jnp.ones((4, 8, 2)), jnp.eye(2), jnp.ones(2) / 2, interpret=interpret)


def _hmm_counts(interpret):
    return hmm_forward_backward_counts_pallas(
        jnp.ones((4, 8, 2)), jnp.eye(2), jnp.ones(2) / 2, interpret=interpret)


def _hgf(interpret):
    return hgf_filter_pallas(jnp.ones((4, 8)), interpret=interpret)


KERNEL_CALLS = {"lgssm": _lgssm, "hmm": _hmm, "hmm_counts": _hmm_counts,
                "hgf": _hgf}


@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_kernels_refuse_to_run_without_gpu_or_interpret(name):
    """No hidden interpreter: off a GPU the kernel raises unless the caller
    asks for interpret mode — and then it runs."""
    call = KERNEL_CALLS[name]
    if jax.devices()[0].platform == "gpu":
        jax.block_until_ready(call(False))
    else:
        with pytest.raises(RuntimeError, match="interpret=True"):
            call(False)
    jax.block_until_ready(call(True))


def _lowered_text(fn, *args):
    return fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()


@pytest.mark.parametrize("kernel", [
    "lgssm", "hmm_k4", "hmm_k16", "hgf_filter_only", "hgf_all_tracks_bf16",
])
def test_kernels_lower_to_triton_at_bench_widths(kernel):
    """The compiled route, checked without a card: each kernel lowers from
    Pallas to a Triton custom call at its bench width (power-of-two blocks,
    ops the Triton lowering supports).  Compiling the Triton IR to PTX
    happens on the GPU only."""
    from cortex_tpu.ops import pallas_hgf, pallas_hmm, pallas_kernels

    if kernel == "lgssm":
        text = _lowered_text(pallas_kernels._smooth, jnp.zeros((10_000, 100)),
                             1.0, 1.0, 1.0, 1.0, 32, False)
    elif kernel.startswith("hmm"):
        K = int(kernel[5:])
        tile = pallas_hmm._plan(4096, K, None)
        text = _lowered_text(pallas_hmm._forward_backward,
                             jnp.zeros((4096, 64, K)), jnp.eye(K),
                             jnp.ones(K) / K, True, tile, False)
    else:
        tracks = () if kernel == "hgf_filter_only" else ALL_TRACKS
        dtype = jnp.dtype(jnp.bfloat16 if tracks else jnp.float32)
        text = _lowered_text(pallas_hgf._hgf_filter, jnp.zeros((65536, 256)),
                             tracks, dtype, 1.0, -2.0, 0.05, 10.0, 20.0, 1e-2,
                             5.0, 128, False)
    assert "__gpu$xla.gpu.triton" in text


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(KERNEL_CALLS))
def test_kernels_compiled_on_gpu_match_xla(name, gpu):
    """On a GPU, each kernel compiled for the card agrees with its plain
    XLA counterpart at a small width."""
    rng = np.random.default_rng(0)
    with jax.default_device(gpu):
        if name == "lgssm":
            y = jnp.asarray(rng.normal(size=(300, 50)).cumsum(-1), jnp.float32)
            got, want = lgssm_smooth_pallas(y).mean, lgssm_smooth_scan(y).mean
        elif name.startswith("hmm"):
            lik = jnp.asarray(rng.random((300, 20, 4)) + 0.1, jnp.float32)
            A = jnp.full((4, 4), 0.25)
            pi = jnp.full((4,), 0.25)
            fn = (hmm_forward_backward_counts_pallas if name == "hmm_counts"
                  else hmm_forward_backward_pallas)
            got = fn(lik, A, pi).gamma
            want = jnp.exp(hmm_forward_backward(
                jnp.log(lik), jnp.log(A), jnp.log(pi)).log_gamma)
        else:
            u = jnp.asarray(rng.normal(size=(300, 40)).cumsum(-1) * 0.1,
                            jnp.float32)
            got = hgf_filter_pallas(u)[1][0]
            want = HGF().filter(u)[1].mu1
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)
