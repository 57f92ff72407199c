"""Loopy Gaussian belief propagation on arbitrary pairwise MRFs.

The reference's BP resolver wires message dependencies for *any* bipartite
factor graph, including cyclic ones — its engine just keeps sweeping until
quiescence (`/root/reference/src/dependencies.jl:17-126`,
`src/inference_engine.jl:575-607`; cyclic signal graphs are exercised in
`test/signal_tests.jl:467-507`).  This module is the batched execution of
that loop for the Gaussian case: **synchronous (Jacobi) GaBP** where every
directed edge's message updates at once per iteration —

    gather (reverse messages) → elementwise update → segment-sum scatter

over packed edge arrays, `lax.scan` over iterations, replicas broadcast on
leading axes.  For walk-summable models the fixed-point means are the exact
posterior means (Weiss & Freeman 2001); variances are the standard GaBP
approximation (exact on trees).

Model, information form:  p(x) ∝ exp(−½ xᵀΛx + ηᵀx)  with sparse Λ given as
node diagonals ``lam_diag`` and undirected edges ``(edges, lam_off)``.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["GaBPResult", "gabp_solve", "gabp_grid_solve", "grid_edges"]


class GaBPResult(NamedTuple):
    """Marginal beliefs: ``mean`` shaped like ``eta`` (``(..., n)``);
    ``variance`` shaped ``(n,)`` (precisions depend only on the shared graph,
    not on the per-replica ``eta``); ``delta`` — the max message change at
    the last iteration (convergence diagnostic)."""

    mean: jax.Array
    variance: jax.Array
    delta: jax.Array


def grid_edges(h: int, w: int) -> np.ndarray:
    """Undirected 4-neighbor grid edge list, shape ``(E, 2)`` — the standard
    loopy-BP benchmark topology (image denoising / smoothing)."""
    idx = np.arange(h * w).reshape(h, w)
    right = np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], axis=1)
    down = np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], axis=1)
    return np.concatenate([right, down], axis=0)


def gabp_solve(
    lam_diag: jax.Array,
    eta: jax.Array,
    edges: jax.Array,
    lam_off: jax.Array,
    n_iters: int = 50,
    damping: float = 0.7,
) -> GaBPResult:
    """Run synchronous damped GaBP; returns marginal means/variances.

    ``lam_diag``: ``(n,)`` node precisions (Λ_ii); ``eta``: ``(..., n)``
    information vector (leading axes are independent replicas sharing the
    graph); ``edges``: ``(E, 2)`` undirected vertex pairs; ``lam_off``:
    ``(E,)`` off-diagonal couplings Λ_ij.  Requires Λ_ii > 0; convergence is
    guaranteed for walk-summable (e.g. diagonally dominant) models.
    """
    lam_diag = jnp.asarray(lam_diag)
    eta = jnp.asarray(eta)
    edges = jnp.asarray(edges)
    lam_off = jnp.asarray(lam_off)
    n = lam_diag.shape[-1]
    E = edges.shape[0]

    # Directed edge arrays: edge e < E is u→v, edge e+E is v→u; the reverse
    # of directed edge d is (d + E) mod 2E.
    src = jnp.concatenate([edges[:, 0], edges[:, 1]])
    dst = jnp.concatenate([edges[:, 1], edges[:, 0]])
    lam_e = jnp.concatenate([lam_off, lam_off])
    batch_shape = eta.shape[:-1]

    def reverse(m):
        return jnp.roll(m, E, axis=-1)

    def step(state, _):
        m_lam, m_eta = state  # (2E,), (..., 2E)
        # Node aggregates of inbound messages.
        agg_lam = jnp.zeros((n,), lam_diag.dtype).at[dst].add(m_lam)
        agg_eta = (
            jnp.zeros(batch_shape + (n,), eta.dtype).at[..., dst].add(m_eta)
        )
        # Cavity at the source of each directed edge: all inbound except the
        # reverse message.
        cav_lam = lam_diag[src] + agg_lam[src] - reverse(m_lam)
        cav_eta = eta[..., src] + agg_eta[..., src] - reverse(m_eta)
        new_lam = -(lam_e**2) / cav_lam
        new_eta = -lam_e * cav_eta / cav_lam
        m_lam_next = (1.0 - damping) * m_lam + damping * new_lam
        m_eta_next = (1.0 - damping) * m_eta + damping * new_eta
        delta = jnp.maximum(
            jnp.max(jnp.abs(m_lam_next - m_lam)),
            jnp.max(jnp.abs(m_eta_next - m_eta)),
        )
        return (m_lam_next, m_eta_next), delta

    init = (
        jnp.zeros((2 * E,), lam_diag.dtype),
        jnp.zeros(batch_shape + (2 * E,), eta.dtype),
    )
    (m_lam, m_eta), deltas = lax.scan(step, init, None, length=n_iters)

    post_lam = lam_diag + jnp.zeros((n,), lam_diag.dtype).at[dst].add(m_lam)
    post_eta = eta + jnp.zeros(batch_shape + (n,), eta.dtype).at[..., dst].add(m_eta)
    return GaBPResult(post_eta / post_lam, 1.0 / post_lam, deltas[-1])


def gabp_grid_solve(
    lam_diag: jax.Array,
    eta: jax.Array,
    lam_off: float,
    n_iters: int = 50,
    damping: float = 0.7,
) -> GaBPResult:
    """Grid-specialized GaBP: identical marginals to :func:`gabp_solve` on a
    4-neighbor grid with uniform coupling, but *stencil-shaped* — messages
    live in four dense ``(H, W)`` direction planes updated with shifted
    slices, so one iteration is pure elementwise math with zero
    gather/scatter.

    ``lam_diag``: ``(H, W)`` node precisions; ``eta``: ``(..., H, W)``
    (leading replica axes); ``lam_off``: scalar coupling Λ_ij of every edge.
    """
    lam_diag = jnp.asarray(lam_diag)
    eta = jnp.asarray(eta)
    H, W = lam_diag.shape
    batch = eta.shape[:-2]
    w2 = lam_off * lam_off

    # m_*[d] = message INTO node (i, j) from its neighbor in direction d:
    # 0: from left (i, j-1), 1: from right (i, j+1), 2: from above (i-1, j),
    # 3: from below (i+1, j).  Border messages are structurally zero and kept
    # zero by masking.
    mask = [
        jnp.concatenate([jnp.zeros((H, 1)), jnp.ones((H, W - 1))], axis=1),
        jnp.concatenate([jnp.ones((H, W - 1)), jnp.zeros((H, 1))], axis=1),
        jnp.concatenate([jnp.zeros((1, W)), jnp.ones((H - 1, W))], axis=0),
        jnp.concatenate([jnp.ones((H - 1, W)), jnp.zeros((1, W))], axis=0),
    ]

    def shift(x, d):
        """Move values to the neighbor the message flows into (zero fill)."""
        if d == 0:  # into-from-left plane: source value at (i, j-1)
            return jnp.pad(x[..., :, :-1], [(0, 0)] * (x.ndim - 2) + [(0, 0), (1, 0)])
        if d == 1:
            return jnp.pad(x[..., :, 1:], [(0, 0)] * (x.ndim - 2) + [(0, 0), (0, 1)])
        if d == 2:
            return jnp.pad(x[..., :-1, :], [(0, 0)] * (x.ndim - 2) + [(1, 0), (0, 0)])
        return jnp.pad(x[..., 1:, :], [(0, 0)] * (x.ndim - 2) + [(0, 1), (0, 0)])

    opposite = (1, 0, 3, 2)

    def step(state, _):
        m_lam, m_eta = state  # tuples of 4 planes
        tot_lam = lam_diag + sum(m_lam)
        tot_eta = eta + sum(m_eta)
        new_lam, new_eta = [], []
        delta = 0.0
        for d in range(4):
            # Cavity at the SOURCE node of the message arriving from
            # direction d: everything except what the target sent back.
            cav_lam = shift(tot_lam - m_lam[opposite[d]], d)
            cav_eta = shift(tot_eta - m_eta[opposite[d]], d)
            safe = jnp.where(mask[d] > 0, cav_lam, 1.0)
            nl = jnp.where(mask[d] > 0, -w2 / safe, 0.0)
            ne = jnp.where(mask[d] > 0, -lam_off * cav_eta / safe, 0.0)
            nl = (1.0 - damping) * m_lam[d] + damping * nl
            ne = (1.0 - damping) * m_eta[d] + damping * ne
            delta = jnp.maximum(
                delta,
                jnp.maximum(
                    jnp.max(jnp.abs(nl - m_lam[d])), jnp.max(jnp.abs(ne - m_eta[d]))
                ),
            )
            new_lam.append(nl)
            new_eta.append(ne)
        return (tuple(new_lam), tuple(new_eta)), delta

    zeros_l = tuple(jnp.zeros((H, W), lam_diag.dtype) for _ in range(4))
    zeros_e = tuple(jnp.zeros(batch + (H, W), eta.dtype) for _ in range(4))
    (m_lam, m_eta), deltas = lax.scan(step, (zeros_l, zeros_e), None, length=n_iters)

    post_lam = lam_diag + sum(m_lam)
    post_eta = eta + sum(m_eta)
    return GaBPResult(post_eta / post_lam, 1.0 / post_lam, deltas[-1])
