"""Analytic example likelihoods (reference ``likelihoods/examples/``).

Every factory returns a JAX-traceable ``loglikelihood(theta)`` closure; the
engine vmaps it over the chain batch, so expressions here execute as fused
(B, D) vector ops on the device.  Math and constants follow the cited
reference files exactly (they are the correctness oracles — e.g. the
normalised Gaussian integrates to Z = 1 over an infinite prior).

Parameter-axis convention: every closure reduces over ``axis=0`` and
broadcasts per-dim constants with :func:`_bc`, so the SAME function
evaluates a single point ``theta (D,)`` or a block of points with the
parameter axis first, ``theta (D, ...)``.
"""

from __future__ import annotations

import math

import jax
import jax.numpy as jnp
import numpy as np

LOG_TWO_PI = math.log(2.0 * math.pi)
LOG_SQRT_TWO_PI = 0.5 * LOG_TWO_PI


def _bc(v, theta):
    """Broadcast a per-dimension (D,) constant against (D, ...) tile input."""
    v = jnp.asarray(v)
    if v.ndim == 0:
        return v
    return v.reshape(v.shape + (1,) * (theta.ndim - 1))


def _log_vn(n: int) -> float:
    """log volume of the n-ball (utils.F90:754-765)."""
    return 0.5 * n * math.log(math.pi) - math.lgamma(1.0 + 0.5 * n)


def gaussian(n_dims: int, mu: float = 0.5, sigma: float = 0.1):
    """Normalised uncorrelated Gaussian (gaussian.f90:12-41): Z = 1 over an
    infinite prior. Derived params: radius and log enclosed prior volume."""

    norm = -n_dims * (math.log(sigma) + LOG_SQRT_TWO_PI)
    log_vn = _log_vn(n_dims)

    def loglikelihood(theta):
        d = (theta - mu) / sigma
        logL = norm - 0.5 * jnp.sum(d * d, axis=0)
        r = jnp.sqrt(jnp.sum((theta - mu) ** 2, axis=0))
        return logL, jnp.stack([r, n_dims * jnp.log(r) + log_vn])

    return loglikelihood


def half_gaussian(n_dims: int, sigma: float = 0.1):
    """half_gaussian.f90: first coordinate restricted to a half-Gaussian at 0,
    others centred at 0.5; normalisation includes the +log 2."""
    mu = np.full(n_dims, 0.5)
    mu[0] = 0.0
    mu_j = jnp.asarray(mu)
    norm = -n_dims * (math.log(sigma) + LOG_SQRT_TWO_PI) + math.log(2.0)
    log_vn = _log_vn(n_dims)

    def loglikelihood(theta):
        d = (theta - _bc(mu_j, theta)) / sigma
        logL = norm - 0.5 * jnp.sum(d * d, axis=0)
        r = jnp.sqrt(jnp.sum(d * d, axis=0)) * sigma
        return logL, jnp.stack([r, n_dims * jnp.log(r) + log_vn - math.log(2.0)])

    return loglikelihood


def pyramidal(n_dims: int, mu: float = 0.5, sigma: float = 0.1):
    """pyramidal.f90: L_inf-norm pyramid, normalised."""
    factor = math.exp(-2.0 / n_dims * math.lgamma(1.0 + 0.5 * n_dims)) * (
        math.pi / 2.0
    )
    norm = -n_dims * (LOG_SQRT_TWO_PI + math.log(sigma))

    def loglikelihood(theta):
        return norm - jnp.max(jnp.abs(theta - mu) / sigma, axis=0) ** 2 / factor

    return loglikelihood


def rastrigin(n_dims: int, A: float = 10.0):
    """rastrigin.f90: upside-down Rastrigin, per-dim normalisation 4991.2175."""
    log_norm = math.log(4991.21750)

    def loglikelihood(theta):
        return -jnp.sum(
            log_norm + theta**2 - A * jnp.cos(2.0 * math.pi * theta), axis=0
        )

    return loglikelihood


def twin_gaussian(n_dims: int, sigma: float = 0.1):
    """twin_gaussian.f90: equal mixture of two Gaussians at (∓0.5, ∓0.5, 0...)."""
    mu1 = np.zeros(n_dims)
    mu2 = np.zeros(n_dims)
    mu1[: min(2, n_dims)] = -0.5
    mu2[: min(2, n_dims)] = +0.5
    mu1_j, mu2_j = jnp.asarray(mu1), jnp.asarray(mu2)
    norm = -n_dims * (math.log(sigma) + LOG_SQRT_TWO_PI)

    def loglikelihood(theta):
        l1 = norm - 0.5 * jnp.sum(((theta - _bc(mu1_j, theta)) / sigma) ** 2, axis=0)
        l2 = norm - 0.5 * jnp.sum(((theta - _bc(mu2_j, theta)) / sigma) ** 2, axis=0)
        logL = jnp.logaddexp(l1, l2) - math.log(2.0)
        phi = jnp.where(theta[0] > 0.5, 1.0, -1.0)[None]
        return logL, phi

    return loglikelihood


def himmelblau(n_dims: int = 2):
    """himmelblau.f90: four-mode 2-D benchmark, normalised."""
    norm = -math.log(0.4071069421432255)

    def loglikelihood(theta):
        return (
            norm
            - (theta[0] ** 2 + theta[1] - 11.0) ** 2
            - (theta[0] + theta[1] ** 2 - 7.0) ** 2
        )

    return loglikelihood


def _rosenbrock_det(n: int, b: float = 100.0) -> float:
    """Tridiagonal determinant recurrence from rosenbrock.f90:76-96."""

    def recur(k: int) -> float:
        if k <= 0:
            return 0.0
        if k == 1:
            return 1.0
        return (-2.0 - 10.0 * b) * recur(k - 1) - 16.0 * b * b * recur(k - 2)

    return abs(-2.0 * b * recur(n - 1) - 16.0 * b * b * recur(n - 2))


def rosenbrock(n_dims: int, a: float = 1.0, b: float = 100.0):
    """rosenbrock.f90: upside-down banana, 2-D normalised."""
    norm = -0.5 * math.log(math.pi**n_dims / _rosenbrock_det(n_dims, b))

    def loglikelihood(theta):
        return norm - jnp.sum(
            (a - theta[:-1]) ** 2 + b * (theta[1:] - theta[:-1] ** 2) ** 2, axis=0
        )

    return loglikelihood


def eggbox(n_dims: int):
    """eggbox.f90: -(2 + prod cos(theta_i/2))^5."""

    def loglikelihood(theta):
        # product over the parameter axis, unrolled in a fixed order
        c = jnp.cos(theta / 2.0)
        p = c[0]
        for i in range(1, n_dims):
            p = p * c[i]
        return -((2.0 + p) ** 5)

    return loglikelihood


def _shell_norm(n_dims: int, radius: float, sigma: float) -> float:
    """Peak normalisation A from gaussian_shell.f90:21-26."""
    r0 = (radius + math.sqrt(radius**2 + 4 * (n_dims - 1) * sigma**2)) / 2
    logf0 = (
        -((radius - r0) ** 2) / 2 / sigma**2
        + (n_dims - 1) * math.log(r0)
        + math.log(float(n_dims))
        + n_dims / 2.0 * math.log(math.pi)
        - math.lgamma(1 + n_dims / 2.0)
    )
    sigma0 = sigma * math.sqrt(
        (1 + radius / math.sqrt(radius**2 + 4 * (n_dims - 1) * sigma**2)) / 2.0
    )
    return logf0 + LOG_SQRT_TWO_PI + math.log(sigma0)


def gaussian_shell(n_dims: int, radius: float = 2.0, sigma: float = 0.1):
    """gaussian_shell.f90: single spherical shell at the origin, normalised."""
    A = _shell_norm(n_dims, radius, sigma)

    def loglikelihood(theta):
        r = jnp.sqrt(jnp.sum(theta**2, axis=0))
        logL = -A - (r - radius) ** 2 / (2.0 * sigma * sigma)
        return logL, r[None]

    return loglikelihood


def gaussian_shells(n_dims: int, radius: float = 2.0, sigma: float = 0.1):
    """gaussian_shells.f90:11-58 — the canonical bimodal clustering oracle:
    two equal shells centred at x_1 = ∓3.5, each with local evidence Z/2."""
    A = _shell_norm(n_dims, radius, sigma)

    def loglikelihood(theta):
        # centres at x_1 = -3.5 and +3.5, in per-coordinate arithmetic
        # (axis 0 = parameters)
        rest = jnp.sum(theta[1:] ** 2, axis=0)
        r1 = jnp.sqrt((theta[0] + 3.5) ** 2 + rest)
        r2 = jnp.sqrt((theta[0] - 3.5) ** 2 + rest)
        l1 = -A - (r1 - radius) ** 2 / (2.0 * sigma * sigma)
        l2 = -A - (r2 - radius) ** 2 / (2.0 * sigma * sigma)
        return jnp.logaddexp(l1, l2) - math.log(2.0)

    return loglikelihood


def random_gaussian(n_dims: int, sigma: float = 0.1, seed: int = 0):
    """random_gaussian.f90: correlated Gaussian with a random inverse
    covariance (random_utils.F90:581-614 construction: random orthonormal
    basis with random eigenvalues up to 1/sigma^2)."""
    rng = np.random.default_rng(seed)
    gauss = rng.standard_normal((n_dims, n_dims))
    q, _ = np.linalg.qr(gauss)
    eigs = rng.uniform(0.0, 1.0, n_dims) / sigma**2
    invcov = (q * eigs) @ q.T
    sign, logdet = np.linalg.slogdet(np.linalg.inv(invcov))
    mu = 0.5
    invcov_j = jnp.asarray(invcov)
    norm = -0.5 * (n_dims * LOG_TWO_PI + logdet)

    def loglikelihood(theta):
        d = theta - mu
        # HIGHEST: a TF32 product would round the quadratic form that the
        # contour test compares
        return norm - 0.5 * jnp.einsum(
            "i...,ij,j...->...", d, invcov_j, d,
            precision=jax.lax.Precision.HIGHEST,
        )

    return loglikelihood


LIKELIHOODS = {
    "gaussian": gaussian,
    "half_gaussian": half_gaussian,
    "pyramidal": pyramidal,
    "rastrigin": rastrigin,
    "twin_gaussian": twin_gaussian,
    "himmelblau": himmelblau,
    "rosenbrock": rosenbrock,
    "eggbox": eggbox,
    "gaussian_shell": gaussian_shell,
    "gaussian_shells": gaussian_shells,
    "random_gaussian": random_gaussian,
}


def get_likelihood(name: str, n_dims: int, **kwargs):
    """Look up an example likelihood by its reference name."""
    try:
        factory = LIKELIHOODS[name]
    except KeyError:
        raise KeyError(
            f"unknown example likelihood {name!r}; available: "
            f"{sorted(LIKELIHOODS)}"
        ) from None
    return factory(n_dims, **kwargs)
