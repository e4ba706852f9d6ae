"""Batched point evaluation: cube -> (theta, phi, logL).

Batched equivalent of the reference ``calculate_point``
(``src/polychord/calculate.f90:6-50``): points outside the unit hypercube are
assigned ``logL = LOG_ZERO`` without calling the likelihood, physical points
get ``theta = prior(cube)`` and ``logL, phi = loglikelihood(theta)``.

Two paths share one interface:

* **traced path** — prior and likelihood are JAX-traceable; they are vmapped
  over the chain batch so every evaluation in the slice engine's inner loop is
  a single fused (B, D) device computation.
* **callback path** — arbitrary Python/numpy likelihoods (the reference's FFI
  trampoline analogue, ``interfaces.F90:438-457``) are invoked on the host via
  ``jax.pure_callback`` at batch granularity.  This keeps the engine jitted
  while supporting non-JAX models; it is the slow-likelihood compatibility
  mode, where callback overhead is negligible by construction.
"""

from __future__ import annotations

from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .logspace import LOG_ZERO
from .precision import real_dtype


class DerivedMismatchError(ValueError):
    """The likelihood's derived-parameter return does not match the declared
    ``nDerived`` — raised loudly rather than silently writing zero columns."""


def _normalise_like_output(out, n_phi: int, n_derived_decl: int = 0):
    """Accept the reference's tuple-or-scalar likelihood return convention
    (``pypolychord/polychord.py:581-587``)."""
    if isinstance(out, tuple):
        logL, phi = out
        phi = jnp.atleast_1d(jnp.asarray(phi, dtype=real_dtype()))
        if phi.shape[0] == 0:
            # `return logL, []` with nDerived=0: the internal phi slot is
            # padded to width 1 (see n_phi) — an empty return must not
            # fail the reshape below, or the traceability probe would
            # silently demote the model to the ~50x slower host-callback
            # path (found via benchmarks/run_matrix.py quickstart).  With
            # nDerived > 0 declared, an empty return is a model bug: error
            # loudly instead of writing all-zero derived columns.
            if n_derived_decl > 0:
                raise DerivedMismatchError(
                    f"likelihood returned no derived parameters but "
                    f"nDerived={n_derived_decl} was declared"
                )
            phi = jnp.zeros((n_phi,), dtype=real_dtype())
    else:
        logL = out
        phi = jnp.zeros((n_phi,), dtype=real_dtype())
    return jnp.asarray(logL, dtype=real_dtype()), phi.reshape((n_phi,))


def is_traceable(fn: Callable, example_shape) -> bool:
    """True if ``fn`` can be traced by JAX on an abstract input."""
    try:
        jax.eval_shape(fn, jax.ShapeDtypeStruct(example_shape, real_dtype()))
        return True
    except Exception:
        return False


_CALC_CACHE = {}
_CALC_CACHE_MAX = 32


def make_batched_calculator(
    prior_fn: Callable,
    loglike_fn: Callable,
    n_dims: int,
    n_derived: int,
    logzero: float = LOG_ZERO,
    force_callback: bool = False,
):
    """Build ``calc(cube_batch) -> (theta, phi, logL)`` with calculate_point
    semantics, choosing the traced or host-callback path automatically.

    Memoised on the (prior, likelihood, dims, dtype) identity: repeated
    ``run()`` calls with the same function objects reuse the SAME calc —
    and therefore every downstream jit cache (engines, chains, theta
    host-path), avoiding the multi-second per-run retrace+recompile that
    dominated short runs (round-5 profile).  A fresh closure per call
    simply misses the cache (no behaviour change)."""
    try:
        cache_key = (
            prior_fn, loglike_fn, n_dims, n_derived, float(logzero),
            force_callback, real_dtype().__name__
            if hasattr(real_dtype(), "__name__") else str(real_dtype()),
        )
        hash(cache_key)
    except TypeError:
        cache_key = None
    if cache_key is not None and cache_key in _CALC_CACHE:
        return _CALC_CACHE[cache_key]

    # keep a non-empty trailing axis: every baby record has a phi slot
    n_phi = max(n_derived, 1)

    use_callback = force_callback
    if not use_callback:

        def _probe(theta):
            return _normalise_like_output(loglike_fn(theta), n_phi, n_derived)

        def _like_traceable():
            # a DerivedMismatchError is a model bug, not a reason to demote
            # to the host-callback path (which would mask it with zeros)
            try:
                jax.eval_shape(
                    _probe, jax.ShapeDtypeStruct((n_dims,), real_dtype())
                )
                return True
            except DerivedMismatchError:
                raise
            except Exception:
                return False

        use_callback = not (is_traceable(prior_fn, (n_dims,)) and _like_traceable())

    if not use_callback:

        def _single(cube):
            theta = jnp.asarray(prior_fn(cube), dtype=real_dtype())
            logL, phi = _normalise_like_output(loglike_fn(theta), n_phi, n_derived)
            return theta, phi, logL

        raw_eval = jax.vmap(_single)
    else:

        def _host_eval(cube_np):
            cube_np = np.asarray(cube_np, dtype=np.float64)
            B = cube_np.shape[0]
            thetas = np.zeros((B, n_dims), dtype=real_dtype())
            phis = np.zeros((B, n_phi), dtype=real_dtype())
            logLs = np.full((B,), logzero, dtype=real_dtype())
            for i in range(B):
                theta = np.asarray(prior_fn(cube_np[i]), dtype=np.float64)
                out = loglike_fn(theta)
                if isinstance(out, tuple):
                    logL, phi = out
                    phi = np.atleast_1d(np.asarray(phi, dtype=np.float64))
                    if len(phi) == 0 and n_derived > 0:
                        raise DerivedMismatchError(
                            f"likelihood returned no derived parameters "
                            f"but nDerived={n_derived} was declared"
                        )
                else:
                    logL, phi = out, np.zeros((n_phi,))
                thetas[i] = theta
                phis[i, : len(phi)] = phi[:n_phi]
                logLs[i] = logL
            return thetas, phis, logLs

        def raw_eval(cube):
            B = cube.shape[0]
            shapes = (
                jax.ShapeDtypeStruct((B, n_dims), real_dtype()),
                jax.ShapeDtypeStruct((B, n_phi), real_dtype()),
                jax.ShapeDtypeStruct((B,), real_dtype()),
            )
            return jax.pure_callback(_host_eval, shapes, cube)

    def calc_point_batch(cube):
        """(B, D) cube -> (theta (B,D), phi (B,n_phi), logL (B,)).

        Out-of-cube points: theta = 0, logL = logzero, likelihood untouched
        (calculate.f90:36-42). NaN likelihoods are treated as unphysical (the
        sanitiser analogue of the reference debug FPE traps, SURVEY §5.3).
        """
        inside = jnp.all((cube >= 0.0) & (cube <= 1.0), axis=1)
        cube_c = jnp.clip(cube, 0.0, 1.0)
        theta, phi, logL = raw_eval(cube_c)
        logL = jnp.where(jnp.isnan(logL), logzero, logL)
        logL = jnp.where(inside, logL, logzero)
        theta = jnp.where(inside[:, None], theta, 0.0)
        phi = jnp.where(inside[:, None], phi, 0.0)
        return theta, phi, logL

    calc_point_batch.uses_callback = use_callback
    calc_point_batch.n_phi = n_phi

    theta_cache = {}
    if not use_callback:

        def theta_batch_host(cube_np):
            """theta = prior(cube) with calculate_point's cube-wall rule,
            evaluated ON THE HOST CPU backend.  Lets the epoch runner drop
            the theta columns from the device fetch (~40-50% of the
            nursery payload) and re-derive them here."""
            import numpy as _np

            # MUST be a process-local device: under jax.distributed,
            # jax.devices() is the global list and process != 0 would grab
            # a non-addressable device ("Fetching value for `jax.Array`
            # that spans non-addressable devices").
            cpu = jax.local_devices(backend="cpu")[0]
            if "fn" not in theta_cache:
                def _theta(cube):
                    inside = jnp.all((cube >= 0.0) & (cube <= 1.0), axis=1)
                    th = jax.vmap(
                        lambda c: jnp.asarray(
                            prior_fn(jnp.clip(c, 0.0, 1.0)),
                            dtype=real_dtype(),
                        )
                    )(cube)
                    return jnp.where(inside[:, None], th, 0.0)

                theta_cache["fn"] = jax.jit(_theta)
            with jax.default_device(cpu):
                return _np.asarray(theta_cache["fn"](jnp.asarray(cube_np)))

        calc_point_batch.theta_batch_host = theta_batch_host

    # --- decomposed fast/slow support (models/graded.py) -------------------
    from ..models.graded import GradedLikelihood

    calc_point_batch.graded = False
    if isinstance(loglike_fn, GradedLikelihood) and not use_callback:
        n_slow = loglike_fn.n_slow

        def _slow_aux_one(cube):
            theta = jnp.asarray(
                prior_fn(jnp.clip(cube, 0.0, 1.0)), dtype=real_dtype()
            )
            return loglike_fn.slow_fn(theta[:n_slow])

        def _fast_one(aux, cube):
            theta = jnp.asarray(
                prior_fn(jnp.clip(cube, 0.0, 1.0)), dtype=real_dtype()
            )
            logL, phi = _normalise_like_output(
                loglike_fn.fast_fn(aux, theta), n_phi, n_derived
            )
            return theta, phi, logL

        slow_aux_v = jax.vmap(_slow_aux_one)
        fast_v = jax.vmap(_fast_one)

        def slow_aux_batch(cube):
            """(B, D) seed cubes -> batched slow-part intermediate."""
            return slow_aux_v(cube)

        def fast_point_batch(aux, cube):
            """Fast-grade probe evaluation with calculate_point semantics
            (cube walls, NaN guard — calculate.f90:36-42), re-using the
            cached slow intermediate."""
            inside = jnp.all((cube >= 0.0) & (cube <= 1.0), axis=1)
            theta, phi, logL = fast_v(aux, cube)
            logL = jnp.where(jnp.isnan(logL), logzero, logL)
            logL = jnp.where(inside, logL, logzero)
            theta = jnp.where(inside[:, None], theta, 0.0)
            phi = jnp.where(inside[:, None], phi, 0.0)
            return theta, phi, logL

        calc_point_batch.graded = True
        calc_point_batch.n_slow = n_slow
        calc_point_batch.slow_aux_batch = slow_aux_batch
        calc_point_batch.fast_point_batch = fast_point_batch
    if cache_key is not None:
        if len(_CALC_CACHE) >= _CALC_CACHE_MAX:
            _CALC_CACHE.pop(next(iter(_CALC_CACHE)))
        _CALC_CACHE[cache_key] = calc_point_batch
    return calc_point_batch
