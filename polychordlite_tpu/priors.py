"""Prior transformation library.

Covers both API surfaces of the reference:

* the vectorised Python prior classes (``pypolychord/priors.py:1-47``) —
  drop-in compatible, but written against ``jax.numpy`` so they trace inside
  the device engine (they also work on plain numpy arrays);
* the block-structured prior system with all 15 prior types
  (``src/polychord/priors.f90:5-20,494-614``) used by the ini-file interface,
  as a jit-traceable ``hypercube_to_physical`` over static blocks.

All transforms are elementwise/scan-free so they vmap cleanly over the chain
batch.  The sequential "forced identifiability" recurrence is re-expressed as
a reverse cumulative sum in log space (mathematically identical to
``priors.f90:242-261``).
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import jax.numpy as jnp
import numpy as np
from jax.scipy.special import erfinv, ndtri

# ---------------------------------------------------------------------------
# pypolychord-compatible prior classes (pypolychord/priors.py)
# ---------------------------------------------------------------------------


def _coord_params(*vals):
    """If any parameter is a vector, return a list of per-coordinate PYTHON
    float tuples (broadcasting scalars); else None.

    Vector-parameter priors unroll to per-coordinate literal arithmetic
    (the parameter axis is axis 0, the convention of models/examples.py),
    so the same prior evaluates a point ``(D,)`` or a block ``(D, ...)``."""
    arrs = [np.atleast_1d(np.asarray(v, dtype=np.float64)) for v in vals]
    n = max(a.size for a in arrs)
    if n == 1:
        return None
    cols = []
    for a in arrs:
        if a.size == 1:
            cols.append([float(a[0])] * n)
        elif a.size == n:
            cols.append([float(x) for x in a])
        else:
            raise ValueError("prior parameter lengths do not broadcast")
    return list(zip(*cols))


class UniformPrior:
    def __init__(self, a, b):
        self.a = a
        self.b = b
        self._coords = _coord_params(a, b)

    def __call__(self, x):
        if self._coords is not None:
            return jnp.stack(
                [a + (b - a) * x[i] for i, (a, b) in enumerate(self._coords)]
            )
        return self.a + (self.b - self.a) * x


class GaussianPrior:
    def __init__(self, mu, sigma):
        self.mu = mu
        self.sigma = sigma
        self._coords = _coord_params(mu, sigma)

    def __call__(self, x):
        if self._coords is not None:
            return jnp.stack(
                [
                    m + s * jnp.sqrt(2.0) * erfinv(2 * x[i] - 1)
                    for i, (m, s) in enumerate(self._coords)
                ]
            )
        return self.mu + self.sigma * jnp.sqrt(2.0) * erfinv(2 * x - 1)


class LogUniformPrior(UniformPrior):
    def __call__(self, x):
        if self._coords is not None:
            return jnp.stack(
                [a * (b / a) ** x[i] for i, (a, b) in enumerate(self._coords)]
            )
        return self.a * (self.b / self.a) ** x


def forced_identifiability_transform(x):
    """Map iid uniforms to sorted uniforms: t_n = prod_{k>=n} x_k^(1/(k+1)).

    Vectorised form of the reference recurrence (priors.f90:242-261,
    pypolychord/priors.py:29-35): log t = reverse-cumsum of log(x)/(rank+1).
    """
    x = jnp.asarray(x)
    n = x.shape[-1]
    ranks = jnp.arange(1, n + 1, dtype=x.dtype)
    logx = jnp.log(jnp.clip(x, 1e-300, None)) / ranks
    logt = jnp.cumsum(logx[..., ::-1], axis=-1)[..., ::-1]
    return jnp.exp(logt)


# Keep the reference's (misspelled) public name for API compatibility.
forced_indentifiability_transform = forced_identifiability_transform


class SortedUniformPrior(UniformPrior):
    def __call__(self, x):
        return super().__call__(forced_identifiability_transform(x))


class LogSortedUniformPrior(LogUniformPrior):
    def __call__(self, x):
        return super().__call__(forced_identifiability_transform(x))


# ---------------------------------------------------------------------------
# Block-structured prior system (priors.f90)
# ---------------------------------------------------------------------------

PRIOR_TYPES = (
    "uniform",
    "log_uniform",
    "power_uniform",
    "gaussian",
    "half_gaussian",
    "exponential",
    "sorted_uniform",
    "sorted_gaussian",
    "sorted_half_gaussian",
    "sorted_exponential",
    "adaptive_sorted_uniform",
    "adaptive_sorted_gaussian",
    "adaptive_sorted_half_gaussian",
    "adaptive_sorted_exponential",
    "nn_adaptive_layer_gaussian",
)


@dataclasses.dataclass(frozen=True)
class PriorBlock:
    """One prior block: a set of parameters transformed together.

    Mirrors the reference ``prior`` type (priors.f90:22-29): static hypercube
    and physical index maps plus a flat parameter vector whose layout depends
    on the prior type (interleaved per-parameter values).
    """

    prior_type: str
    hypercube_indices: tuple  # 0-based
    physical_indices: tuple  # 0-based
    parameters: tuple

    @property
    def npars(self) -> int:
        return len(self.hypercube_indices)


def _pairs(params, n, stride=2):
    """Split an interleaved parameter vector into per-dimension arrays,
    broadcasting a single tuple across the block if only one was given."""
    p = np.asarray(params, dtype=np.float64)
    if p.size == stride:
        cols = [np.full(n, p[i]) for i in range(stride)]
    else:
        cols = [p[i::stride] for i in range(stride)]
    return [jnp.asarray(c) for c in cols]


def _uniform_htp(x, params):
    a, b = _pairs(params, x.shape[-1])
    return a + (b - a) * x


def _log_uniform_htp(x, params):
    a, b = _pairs(params, x.shape[-1])
    return a * (b / a) ** x


def _power_uniform_htp(x, params):
    # theta^(1/power) uniform; power negative (priors.f90:147-167).
    a, b, power = _pairs(params, x.shape[-1], stride=3)
    const = 1.0 / jnp.abs(a ** (1.0 / power) - b ** (1.0 / power))
    phys = a ** (1.0 / power) - x / const
    return phys**power


def _gaussian_htp(x, params):
    mu, sigma = _pairs(params, x.shape[-1])
    return mu + sigma * ndtri(jnp.clip(x, 1e-300, 1.0 - 1e-16))


def _half_gaussian_htp(x, params):
    return _gaussian_htp(0.5 + 0.5 * x, params)


def _exponential_htp(x, params):
    (lam,) = _pairs(params, x.shape[-1], stride=1)
    return -jnp.log1p(-jnp.clip(x, 0.0, 1.0 - 1e-16)) / lam


def _sort_hypercube(x):
    return forced_identifiability_transform(x)


def _adaptive_sorted_transform(x):
    """First coordinate selects how many of the rest are sorted
    (priors.f90:363-384); re-expressed with a masked reverse log-cumsum so the
    data-dependent sort length stays traceable."""
    n = x.shape[-1]
    first = 0.5 + x[..., 0] * (n - 1)
    nfunc = jnp.floor(first + 0.5).astype(jnp.int32)  # round to nearest
    rest = x[..., 1:]
    m = rest.shape[-1]
    idx = jnp.arange(m)
    active = idx < nfunc[..., None]
    ranks = (idx + 1).astype(rest.dtype)
    logx = jnp.where(active, jnp.log(jnp.clip(rest, 1e-300, None)) / ranks, 0.0)
    logt = jnp.cumsum(logx[..., ::-1], axis=-1)[..., ::-1]
    sorted_rest = jnp.where(active, jnp.exp(logt), rest)
    return jnp.concatenate([first[..., None], sorted_rest], axis=-1)


def _make_sorted(base):
    def fn(x, params):
        return base(_sort_hypercube(x), params)

    return fn


def _make_adaptive(base, param_offset):
    def fn(x, params):
        y = _adaptive_sorted_transform(x)
        rest = base(y[..., 1:], tuple(params[param_offset:]))
        return jnp.concatenate([y[..., :1], rest], axis=-1)

    return fn


def _nn_adaptive_layer_gaussian_htp(x, params):
    """priors.f90:469-488: first coord picks 1 vs 2 hidden layers."""
    first = 0.5 + x[..., 0] * 2.0
    rest = x[..., 1:]
    half = _make_adaptive(_half_gaussian_htp, 2)(rest, tuple(params[2:]))
    full = _make_adaptive(_gaussian_htp, 2)(rest, tuple(params[2:]))
    chosen = jnp.where((first < 1.5)[..., None], half, full)
    return jnp.concatenate([first[..., None], chosen], axis=-1)


_HTP = {
    "uniform": _uniform_htp,
    "log_uniform": _log_uniform_htp,
    "power_uniform": _power_uniform_htp,
    "gaussian": _gaussian_htp,
    "half_gaussian": _half_gaussian_htp,
    "exponential": _exponential_htp,
    "sorted_uniform": _make_sorted(_uniform_htp),
    "sorted_gaussian": _make_sorted(_gaussian_htp),
    "sorted_half_gaussian": _make_sorted(_half_gaussian_htp),
    "sorted_exponential": _make_sorted(_exponential_htp),
    "adaptive_sorted_uniform": _make_adaptive(_uniform_htp, 2),
    "adaptive_sorted_gaussian": _make_adaptive(_gaussian_htp, 2),
    "adaptive_sorted_half_gaussian": _make_adaptive(_half_gaussian_htp, 2),
    "adaptive_sorted_exponential": _make_adaptive(_exponential_htp, 1),
    "nn_adaptive_layer_gaussian": _nn_adaptive_layer_gaussian_htp,
}


def hypercube_to_physical(cube, blocks: Sequence[PriorBlock]):
    """Dispatch over prior blocks (priors.f90:494-556). Traceable; ``cube``
    may have leading batch dimensions."""
    cube = jnp.asarray(cube)
    out = jnp.zeros_like(cube)
    for blk in blocks:
        h = jnp.asarray(blk.hypercube_indices, dtype=jnp.int32)
        p = jnp.asarray(blk.physical_indices, dtype=jnp.int32)
        sub = jnp.take(cube, h, axis=-1)
        phys = _HTP[blk.prior_type](sub, blk.parameters)
        out = _scatter_last(out, p, phys)
    return out


def _scatter_last(arr, idx, vals):
    if arr.ndim == 1:
        return arr.at[idx].set(vals)
    return arr.at[..., idx].set(vals)


def physical_to_hypercube(theta, blocks: Sequence[PriorBlock]):
    """Inverse transform for the 4 invertible types (priors.f90:558-587)."""
    theta = jnp.asarray(theta)
    out = jnp.zeros_like(theta)
    for blk in blocks:
        h = jnp.asarray(blk.hypercube_indices, dtype=jnp.int32)
        p = jnp.asarray(blk.physical_indices, dtype=jnp.int32)
        sub = jnp.take(theta, p, axis=-1)
        if blk.prior_type == "uniform":
            a, b = _pairs(blk.parameters, blk.npars)
            cube = (sub - a) / (b - a)
        elif blk.prior_type == "gaussian":
            mu, sigma = _pairs(blk.parameters, blk.npars)
            z = (sub - mu) / sigma
            cube = 0.5 * (1.0 + jnp.asarray(_erf(z / jnp.sqrt(2.0))))
        elif blk.prior_type == "log_uniform":
            a, b = _pairs(blk.parameters, blk.npars)
            cube = jnp.log(sub / a) / jnp.log(b / a)
        elif blk.prior_type == "sorted_uniform":
            a, b = _pairs(blk.parameters, blk.npars)
            u = (sub - a) / (b - a)
            n = blk.npars
            ratios = jnp.concatenate(
                [u[..., :-1] / jnp.clip(u[..., 1:], 1e-300, None), u[..., -1:]],
                axis=-1,
            )
            powers = jnp.arange(1, n + 1, dtype=u.dtype)
            cube = ratios**powers
        else:
            raise ValueError(
                f"prior type {blk.prior_type!r} has no inverse transform"
            )
        out = _scatter_last(out, h, cube)
    return out


def _erf(z):
    from jax.scipy.special import erf

    return erf(z)


def prior_log_volume(blocks: Sequence[PriorBlock]) -> float:
    """Log prior volume for the types that define one (priors.f90:591-614)."""
    import math

    log_two_pi = math.log(2.0 * math.pi)
    total = 0.0
    for blk in blocks:
        p = np.asarray(blk.parameters, dtype=np.float64)
        if blk.prior_type == "uniform":
            a, b = p[0::2], p[1::2]
            if a.size == 1 and blk.npars > 1:
                total += blk.npars * math.log(b[0] - a[0])
            else:
                total += float(np.sum(np.log(b - a)))
        elif blk.prior_type == "gaussian":
            sig = p[1::2]
            if sig.size == 1 and blk.npars > 1:
                total += blk.npars * (0.5 * log_two_pi + math.log(sig[0]))
            else:
                total += float(np.sum(0.5 * log_two_pi + np.log(sig)))
        elif blk.prior_type == "log_uniform":
            a, b = p[0::2], p[1::2]
            total += float(np.sum(np.log(np.log(b / a))))
        elif blk.prior_type == "sorted_uniform":
            total += math.log(p[1] - p[0]) - math.lgamma(1.0 + blk.npars)
    return total
