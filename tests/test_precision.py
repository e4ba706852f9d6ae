"""f64 escape hatch (ops/precision.py).

The reference is f64 throughout (utils.F90:6); the device engines default to f32.
A likelihood with |logL| ~ 1e7 loses the contour test in the f32
mantissa (ulp(1e7) = 1): precision="highest" switches the scan engine to
f64 and must recover the correct evidence; f32 mode must warn.
"""

import math
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import polychordlite_tpu
from polychordlite_tpu.priors import UniformPrior

SIGMA = 0.1
NDIMS = 2
OFFSET = 1.0e7
ANALYTIC = OFFSET - NDIMS * math.log(2)


def big_like(theta):
    r2 = jnp.sum(theta**2)
    norm = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
    return OFFSET + norm - r2 / (2 * SIGMA**2), [r2]


def run_big(tmp_path, **kw):
    defaults = dict(
        nDerived=1,
        prior=UniformPrior(-1, 1),
        nlive=80,
        num_repeats=2 * NDIMS,
        read_resume=False,
        base_dir=str(tmp_path),
        file_root="p",
        seed=2,
        feedback=0,
        precision_criterion=0.01,
    )
    defaults.update(kw)
    return polychordlite_tpu.run(big_like, NDIMS, **defaults)


class TestPrecision:
    def test_highest_recovers_big_logL_evidence(self, tmp_path):
        out = run_big(tmp_path, precision="highest")
        assert abs(out.logZ - ANALYTIC) < 3 * out.logZerr + 0.2

    def test_f32_mode_warns_on_big_logL(self, tmp_path):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            run_big(tmp_path, file_root="w32", max_ndead=150)
        assert any("f32 contour" in str(x.message) for x in w)

    def test_x64_state_restored(self, tmp_path):
        import jax

        run_big(tmp_path, file_root="r", precision="highest", max_ndead=120)
        assert not jax.config.read("jax_enable_x64")
        # a subsequent default-precision run still works
        out = run_big(tmp_path, file_root="r2", max_ndead=120)
        assert np.isfinite(out.logZ)

    def test_concurrent_mixed_precision_threads(self, tmp_path):
        """The x64 scope is THREAD-LOCAL: a
        highest-precision run and a default-precision run execute
        concurrently on separate threads of one process, both correct."""
        import threading

        results = {}
        errors = []

        def worker(name, **kw):
            try:
                results[name] = run_big(tmp_path / name, **kw)
            except Exception as e:  # surface in the main thread
                errors.append((name, e))

        t64 = threading.Thread(
            target=worker, args=("hi",), kwargs=dict(precision="highest")
        )
        t32 = threading.Thread(target=worker, args=("lo",), kwargs={})
        t64.start()
        t32.start()
        t64.join()
        t32.join()
        assert not errors, errors
        # the f64 run recovers the analytic evidence despite |logL| ~ 1e7
        out64 = results["hi"]
        assert abs(out64.logZ - ANALYTIC) < 3 * out64.logZerr + 0.2
        # the f32 run completed and was NOT flipped to x64 mid-run
        assert np.isfinite(results["lo"].logZ)
        import jax

        assert not jax.config.read("jax_enable_x64")


def _dot_precisions(jaxpr):
    """Precision of every dot_general in a jaxpr, sub-jaxprs included."""
    found = []

    def walk(jx):
        for eqn in jx.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (list, tuple)) else [v]:
                    if hasattr(sub, "jaxpr"):
                        walk(getattr(sub.jaxpr, "jaxpr", sub.jaxpr))
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(jaxpr.jaxpr)
    return found


def _is_highest(p):
    import jax

    hi = jax.lax.Precision.HIGHEST
    return p is not None and all(x == hi for x in (
        p if isinstance(p, tuple) else (p, p)))


class TestFloat32ProductPrecision:
    """A float32 product may run in TF32 on a GPU unless it asks for more:
    every product that feeds the likelihood or the contour test carries
    Precision.HIGHEST (checked in the jaxpr, so it holds on any backend)."""

    @pytest.mark.parametrize("dim", [3, 7, 20])
    def test_cgs2_products_are_highest(self, dim):
        import jax

        from polychordlite_tpu.ops.directions import _gram_schmidt

        jaxpr = jax.make_jaxpr(_gram_schmidt)(jnp.ones((2, dim, dim)))
        precs = _dot_precisions(jaxpr)
        assert precs and all(_is_highest(p) for p in precs)

    def test_make_directions_products_are_highest(self):
        """CGS2, the slot shuffle and the whitening: no product of the
        direction layer runs in TF32, so the card's chains follow the
        CPU's."""
        import jax

        from polychordlite_tpu.ops.directions import make_directions

        D, B = 5, 4
        keys = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(0), i))(
            jnp.arange(B))
        jaxpr = jax.make_jaxpr(
            lambda k, c: make_directions(
                k, c, grade_dims=(D,), num_repeats=(2 * D,), n_dims=D,
                shared_perm_key=jax.random.PRNGKey(1),
            )
        )(keys, jnp.broadcast_to(jnp.eye(D), (B, D, D)))
        precs = _dot_precisions(jaxpr)
        assert len(precs) >= 3 and all(_is_highest(p) for p in precs)

    def test_zoo_quadratic_form_is_highest(self):
        import jax

        from polychordlite_tpu.models import get_likelihood

        like = get_likelihood("random_gaussian", 6)
        precs = _dot_precisions(jax.make_jaxpr(like)(jnp.full((6,), 0.4)))
        assert precs and all(_is_highest(p) for p in precs)
