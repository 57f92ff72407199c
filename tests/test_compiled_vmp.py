"""The reference's mean-field VMP SSM through the COMPILED path.

The gold model of ``test/inference_engine_tests.jl:593-805`` (unknown process
and observation precisions) executed as a static batched program with
role-refined rule groups, iterated to the VMP fixed point.  Must recover the
true precisions like the dynamic engine does.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cortex_tpu.compile import CompiledInference, dep_role_key
from cortex_tpu.models import MeanFieldSSMBatched, make_mean_field_ssm_graph

make_model = make_mean_field_ssm_graph


def test_compiled_mean_field_vmp_recovers_precisions():
    rng = np.random.default_rng(1234)
    n = 100
    ssnoise_real = obsnoise_real = 100.0
    walk = [0.0]
    for _ in range(1, n):
        walk.append(walk[-1] + rng.normal() / np.sqrt(ssnoise_real))
    observations = [
        float(w + rng.normal() / np.sqrt(obsnoise_real)) for w in walk
    ]

    engine, x, y, ssnoise, obsnoise = make_model(n, observations)
    compiled = CompiledInference(
        engine,
        [ssnoise, obsnoise] + x,
        MeanFieldSSMBatched(),
        refine_key=dep_role_key,
    )

    sched = compiled.schedule
    # Observed y marginals are frozen reads (initials), never recomputed.
    y_marg_ids = {id(engine.get_variable_marginal(v)) for v in y}
    scheduled_ids = {
        id(st.signal) for ph in sched.phases for gr in ph for st in gr.steps
    }
    assert not (y_marg_ids & scheduled_ids)
    assert y_marg_ids <= {id(s) for s in sched.initials}
    # Messages batch into a handful of role groups (not O(n) groups).
    n_groups = sum(len(ph) for ph in sched.phases)
    assert n_groups <= 12

    marginals, state = compiled.iterate({}, n_iterations=50)
    q_ss = marginals[ssnoise]
    q_obs = marginals[obsnoise]
    # The compiled path runs *synchronous* mean-field sweeps (all messages
    # from stale marginals, then all marginals); its fixed point differs
    # slightly from the dynamic engine's sequential coordinate updates.  The
    # recovery criterion is scale: both precisions far above the prior mean 1
    # (truth 100).  Exact cross-path agreement on identical data is asserted
    # in test_compiled_vmp_matches_dynamic_fixed_point.
    assert float(q_ss.mean) > 20.0
    assert float(q_obs.mean) > 20.0
    # State marginals are Gaussians tracking the walk.
    errs = [abs(float(marginals[x[i]].mean) - walk[i]) for i in range(n)]
    assert np.mean(errs) < 0.1


def test_compiled_vmp_matches_dynamic_fixed_point():
    """Both paths converge to the same mean-field fixed point."""
    from tests.test_inference_engine import (
        make_mean_field_ssm_model,
    )

    rng = np.random.default_rng(7)
    n = 30
    observations = [float(v) for v in np.cumsum(rng.normal(size=n) * 0.1)]

    # Dynamic path (scalar python algebra).
    engine_d, x_d, y_d, obsnoise_d, ssnoise_d = make_mean_field_ssm_model(n)
    for i in range(n):
        engine_d.get_variable_marginal(y_d[i]).set_value(observations[i])
    for _ in range(60):
        engine_d.update_marginals([ssnoise_d, obsnoise_d] + x_d)
    dyn_ss = engine_d.get_variable_marginal(ssnoise_d).get_value()
    dyn_obs = engine_d.get_variable_marginal(obsnoise_d).get_value()
    dyn_x0 = engine_d.get_variable_marginal(x_d[0]).get_value()

    # Compiled path.
    engine_c, x_c, y_c, ssnoise_c, obsnoise_c = make_model(n, observations)
    compiled = CompiledInference(
        engine_c,
        [ssnoise_c, obsnoise_c] + x_c,
        MeanFieldSSMBatched(),
        refine_key=dep_role_key,
    )
    marginals, _ = compiled.iterate({}, n_iterations=60)

    from tests.test_inference_engine import mean as dyn_mean

    assert float(marginals[ssnoise_c].mean) == pytest.approx(
        dyn_mean(dyn_ss), rel=2e-2
    )
    assert float(marginals[obsnoise_c].mean) == pytest.approx(
        dyn_mean(dyn_obs), rel=2e-2
    )
    assert float(marginals[x_c[0]].mean) == pytest.approx(
        dyn_x0.mean, rel=2e-2, abs=1e-3
    )


def test_no_unschedulable_warning_on_canonical_vmp_model():
    """Frozen observed-y marginals are intentional reads; compiling the
    canonical mean-field SSM must NOT emit the unschedulable-target warning
    (it previously cried wolf on every correct VMP model)."""
    import warnings as _warnings

    rng = np.random.default_rng(5)
    n = 12
    observations = [float(v) for v in np.cumsum(rng.normal(size=n) * 0.1)]
    engine, x, y, ssnoise, obsnoise = make_model(n, observations)
    with _warnings.catch_warnings():
        _warnings.simplefilter("error")
        CompiledInference(
            engine,
            [ssnoise, obsnoise] + x,
            MeanFieldSSMBatched(),
            refine_key=dep_role_key,
        )
    assert not engine.get_warnings()
