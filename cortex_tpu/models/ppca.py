"""Probabilistic PCA and Factor Analysis — latent linear-Gaussian models.

The reference framework's scope is conjugate Gaussian message passing on
factor graphs; PPCA/FA are the canonical *latent linear* members of that
family (one Gaussian latent per datum, linear-Gaussian likelihood), with
EM updates that are exactly closed-form Gaussian message products
(cf. the reference's Gaussian algebra, ``/root/reference/test/runtests.jl:40-84``).

Design: everything is a dense matmul.  The E-step posterior
``M = WᵀW + σ²I`` is a tiny q×q solve; the heavy ops are ``Yᵀ(YW...)``
Gram-style products of shape (d, n)×(n, q) — straight onto the matmul units in
bfloat16/float32 with no reshaping.  The EM loop is a ``lax.fori_loop`` of
fused matmuls: no host round-trips, O(ndq) per iteration.

APIs:
- :func:`ppca_closed_form` — Tipping & Bishop (1999) exact ML via
  eigendecomposition (oracle + fast path for small d).
- :class:`PPCA` ``.fit_em`` — EM for large d (never materializes the d×d
  covariance), ``.log_likelihood`` via the Woodbury/q-space determinant
  lemma, ``.transform`` posterior latents.
- :class:`FactorAnalysis` ``.fit_em`` — per-dimension noise ``psi`` (diag).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["PPCA", "PPCAResult", "FactorAnalysis", "FAResult", "ppca_closed_form"]


class PPCAResult(NamedTuple):
    W: jax.Array  # (d, q) loadings
    sigma2: jax.Array  # () isotropic noise variance
    mu: jax.Array  # (d,) data mean
    log_likelihood: jax.Array  # (n_iters,) trace (EM) or () (closed form)


class FAResult(NamedTuple):
    W: jax.Array  # (d, q)
    psi: jax.Array  # (d,) diagonal noise variances
    mu: jax.Array  # (d,)
    log_likelihood: jax.Array  # (n_iters,)


def _marginal_loglik_iso(Yc: jax.Array, W: jax.Array, sigma2) -> jax.Array:
    """Σ_i log N(y_i; 0, WWᵀ + σ²I) in q-space (Woodbury + det lemma)."""
    n, d = Yc.shape
    q = W.shape[1]
    M = W.T @ W + sigma2 * jnp.eye(q, dtype=W.dtype)
    L = jnp.linalg.cholesky(M)
    # log|C| = (d-q) log σ² + log|M|
    logdet = (d - q) * jnp.log(sigma2) + 2.0 * jnp.sum(
        jnp.log(jnp.diagonal(L))
    )
    # tr(Yc C⁻¹ Ycᵀ) = (||Yc||² - ||L⁻¹ Wᵀ Ycᵀ||²) / σ².  Subtract
    # *per sample* before the global sum: the two global sums are O(n·d)
    # while their difference is O(quad), so subtracting afterwards
    # catastrophically cancels in float32.
    WtY = W.T @ Yc.T  # (q, n)
    half = jax.scipy.linalg.solve_triangular(L, WtY, lower=True)
    per_sample = jnp.sum(Yc * Yc, axis=1) - jnp.sum(half * half, axis=0)
    quad = jnp.sum(per_sample) / sigma2
    return -0.5 * (n * d * jnp.log(2.0 * jnp.pi) + n * logdet + quad)


def ppca_closed_form(Y: jax.Array, n_components: int) -> PPCAResult:
    """Exact ML PPCA (Tipping & Bishop 1999, §3.2) via ``eigh``.

    ``W = U_q (Λ_q − σ²I)^{1/2}``, ``σ² = mean of the d−q trailing
    eigenvalues`` of the sample covariance.  O(d³) — for very large d
    prefer :meth:`PPCA.fit_em`.
    """
    Y = jnp.asarray(Y)
    n, d = Y.shape
    q = n_components
    if not 0 < q < d:
        raise ValueError(
            f"n_components must satisfy 0 < q < d (got q={q}, d={d}); "
            "the isotropic noise estimate averages the d−q trailing "
            "eigenvalues and is undefined at q = d."
        )
    mu = Y.mean(axis=0)
    Yc = Y - mu
    S = (Yc.T @ Yc) / n
    evals, evecs = jnp.linalg.eigh(S)  # ascending
    lam_q = evals[-q:][::-1]
    U_q = evecs[:, -q:][:, ::-1]
    sigma2 = evals[: d - q].sum() / (d - q)
    W = U_q * jnp.sqrt(jnp.maximum(lam_q - sigma2, 0.0))
    ll = _marginal_loglik_iso(Yc, W, sigma2)
    return PPCAResult(W=W, sigma2=sigma2, mu=mu, log_likelihood=ll)


@dataclasses.dataclass(frozen=True)
class PPCA:
    """Isotropic-noise probabilistic PCA with EM fitting.

    ``y_i = W z_i + mu + ε``, ``z_i ~ N(0, I_q)``, ``ε ~ N(0, σ²I_d)``.
    """

    n_components: int

    def fit_em(
        self,
        Y: jax.Array,
        n_iters: int = 100,
        seed: int = 0,
        init: Optional[Tuple[jax.Array, jax.Array]] = None,
    ) -> PPCAResult:
        """EM over (W, σ²); returns the fit plus the per-iteration marginal
        log-likelihood trace (monotonically non-decreasing)."""
        Y = jnp.asarray(Y)
        n, d = Y.shape
        q = self.n_components
        if not 0 < q < d:
            raise ValueError(
                f"n_components must satisfy 0 < q < d (got q={q}, d={d})"
            )
        mu = Y.mean(axis=0)
        Yc = Y - mu
        total_ss = jnp.sum(Yc * Yc)

        if init is not None:
            W0, s0 = init
            W0 = jnp.asarray(W0)
            s0 = jnp.asarray(s0, Y.dtype)
        else:
            # Randomized range-finder init: one power iteration of the
            # sample covariance (two matmuls, never materializing d×d) + QR,
            # scaled by per-column Rayleigh quotients.  EM from a random
            # init crawls when σ² is small relative to the spectral gaps;
            # starting in the right subspace cuts iterations by ~10×.
            omega = jax.random.normal(jax.random.PRNGKey(seed), (d, q), Y.dtype)
            B = Yc.T @ (Yc @ omega) / n  # = S @ omega
            Q_init, _ = jnp.linalg.qr(B)
            lam = jnp.sum((Yc @ Q_init) ** 2, axis=0) / n
            s0 = jnp.maximum((total_ss / n - lam.sum()) / (d - q), 1e-6)
            W0 = Q_init * jnp.sqrt(jnp.maximum(lam - s0, 1e-6))

        eye_q = jnp.eye(q, dtype=Y.dtype)

        def step(carry, _):
            W, sigma2 = carry
            # E-step in q-space: M = WᵀW + σ²I (q×q).
            M = W.T @ W + sigma2 * eye_q
            Minv = jnp.linalg.inv(M)
            # Sufficient statistics (all matmuls):
            #   S_yz = Ycᵀ E[Z]   (d, q);  S_zz = Σ E[z zᵀ]  (q, q)
            YW = Yc @ W  # (n, q)
            EZ = YW @ Minv  # (n, q)
            S_yz = Yc.T @ EZ  # (d, q)
            S_zz = n * sigma2 * Minv + EZ.T @ EZ
            # M-step.
            W_new = jnp.linalg.solve(S_zz.T, S_yz.T).T  # S_yz @ S_zz⁻¹
            # Noise update in residual form — algebraically equal to
            # (total_ss − 2⟨S_yz,W⟩ + ⟨S_zz,WᵀW⟩)/(nd) but a sum of
            # positives: the subtractive form catastrophically cancels in
            # float32 and collapses σ² to the floor.
            resid = Yc - EZ @ W_new.T
            sigma2_new = (
                jnp.sum(resid * resid)
                + n * sigma2 * jnp.sum((W_new @ Minv) * W_new)
            ) / (n * d)
            ll = _marginal_loglik_iso(Yc, W_new, sigma2_new)
            return (W_new, sigma2_new), ll

        (W, sigma2), lls = lax.scan(step, (W0, s0), None, length=n_iters)
        return PPCAResult(W=W, sigma2=sigma2, mu=mu, log_likelihood=lls)

    def log_likelihood(self, Y: jax.Array, result: PPCAResult) -> jax.Array:
        return _marginal_loglik_iso(
            jnp.asarray(Y) - result.mu, result.W, result.sigma2
        )

    def transform(self, Y: jax.Array, result: PPCAResult):
        """Posterior latents: mean (n, q) and shared covariance (q, q)."""
        q = self.n_components
        M = result.W.T @ result.W + result.sigma2 * jnp.eye(q, dtype=result.W.dtype)
        Minv = jnp.linalg.inv(M)
        mean = (jnp.asarray(Y) - result.mu) @ result.W @ Minv
        cov = result.sigma2 * Minv
        return mean, cov


@dataclasses.dataclass(frozen=True)
class FactorAnalysis:
    """Factor analysis: diagonal per-dimension noise ``psi`` (d,)."""

    n_components: int

    def fit_em(
        self, Y: jax.Array, n_iters: int = 200, seed: int = 0
    ) -> FAResult:
        Y = jnp.asarray(Y)
        n, d = Y.shape
        q = self.n_components
        if not 0 < q < d:
            raise ValueError(
                f"n_components must satisfy 0 < q < d (got q={q}, d={d})"
            )
        mu = Y.mean(axis=0)
        Yc = Y - mu
        diag_ss = jnp.sum(Yc * Yc, axis=0) / n  # (d,)

        # Same randomized range-finder init as PPCA (see fit_em above);
        # psi starts at the residual per-dimension variance.
        omega = jax.random.normal(jax.random.PRNGKey(seed), (d, q), Y.dtype)
        B = Yc.T @ (Yc @ omega) / n
        Q_init, _ = jnp.linalg.qr(B)
        lam = jnp.sum((Yc @ Q_init) ** 2, axis=0) / n
        iso = jnp.maximum((diag_ss.sum() - lam.sum()) / (d - q), 1e-6)
        W0 = Q_init * jnp.sqrt(jnp.maximum(lam - iso, 1e-6))
        # Relative floor: starting a dimension at (near-)zero noise is a
        # Heywood-boundary init that float32 EM cannot escape (the pinned
        # dimension gets ~infinite weight and its residual self-fulfills).
        psi0 = jnp.maximum(diag_ss - jnp.sum(W0 * W0, axis=1), 0.05 * diag_ss)
        psi_floor = 1e-6 * diag_ss
        eye_q = jnp.eye(q, dtype=Y.dtype)

        def loglik(W, psi):
            # q-space determinant/Woodbury with C = diag(psi) + WWᵀ.
            Wp = W / psi[:, None]
            M = eye_q + W.T @ Wp
            L = jnp.linalg.cholesky(M)
            logdet = jnp.sum(jnp.log(psi)) + 2.0 * jnp.sum(jnp.log(jnp.diagonal(L)))
            Yp = Yc / jnp.sqrt(psi)
            WtY = Wp.T @ Yc.T  # (q, n)
            half = jax.scipy.linalg.solve_triangular(L, WtY, lower=True)
            # Per-sample subtraction: see _marginal_loglik_iso.
            quad = jnp.sum(
                jnp.sum(Yp * Yp, axis=1) - jnp.sum(half * half, axis=0)
            )
            return -0.5 * (n * d * jnp.log(2.0 * jnp.pi) + n * logdet + quad)

        def step(carry, _):
            W, psi = carry
            Wp = W / psi[:, None]
            M = eye_q + W.T @ Wp  # posterior precision (q, q)
            Minv = jnp.linalg.inv(M)
            EZ = (Yc @ Wp) @ Minv  # (n, q)
            S_yz = Yc.T @ EZ
            S_zz = n * Minv + EZ.T @ EZ
            W_new = jnp.linalg.solve(S_zz.T, S_yz.T).T
            # Residual form (see PPCA.fit_em): float32-safe, positive by
            # construction — the subtractive diag form cancels catastrophically.
            resid = Yc - EZ @ W_new.T
            psi_new = (
                jnp.sum(resid * resid, axis=0) / n
                + jnp.sum((W_new @ Minv) * W_new, axis=1)
            )
            psi_new = jnp.maximum(psi_new, psi_floor)
            return (W_new, psi_new), loglik(W_new, psi_new)

        (W, psi), lls = lax.scan(step, (W0, psi0), None, length=n_iters)
        return FAResult(W=W, psi=psi, mu=mu, log_likelihood=lls)
