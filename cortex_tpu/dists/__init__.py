"""Exponential-family message algebra as batched JAX pytrees.

The batched analogue of the reference's conjugate test algebra
(``/root/reference/test/runtests.jl:17-101``): distributions are
struct-of-arrays pytrees closed under ``*`` (density product = natural-
parameter addition) and ``/`` (cavity quotient), with moments, log
normalizers, entropies and sampling.  Leading axes are batch axes — a single
``Gaussian`` value can hold the messages of 10k replicas at once.
"""

from .gaussian import (
    Gaussian,
    MvGaussian,
    from_mean_precision,
    from_mean_variance,
    mv_from_mean_cov,
    mv_from_mean_precision,
)
from .conjugate import Bernoulli, Beta, Categorical, Dirichlet, Gamma
from .extra import NormalGamma, Poisson, Wishart

__all__ = [
    "Gaussian",
    "MvGaussian",
    "from_mean_variance",
    "from_mean_precision",
    "mv_from_mean_cov",
    "mv_from_mean_precision",
    "Beta",
    "Gamma",
    "Bernoulli",
    "Categorical",
    "Dirichlet",
    "NormalGamma",
    "Wishart",
    "Poisson",
]
