"""Decomposed fast/slow likelihood tests (models/graded.py).

The reference's speed grades exist to win on hierarchical likelihoods
(generate.F90:330-455, chordal_sampling.f90:94-145): fast-parameter moves
must not pay the slow-parameter cost.  These tests build a 2-grade
gaussian whose slow part is made artificially expensive (a 200-iteration
fori_loop) and check: correctness of the evidence, that slow-grade
likelihood evals drop to the slow-repeat share, and that time_speeds
measures a real (>2x) cost ratio.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import polychordlite_tpu
from polychordlite_tpu import GradedLikelihood
from polychordlite_tpu.priors import UniformPrior

SIGMA = 0.15
N_SLOW, N_FAST = 2, 2
NDIMS = N_SLOW + N_FAST
ANALYTIC_LOGZ = -NDIMS * math.log(2)  # normalised gaussian over U[-1,1]^D


def heavy_slow(theta_slow):
    """Slow part: gaussian contribution of the slow block, made ~200x more
    expensive with a redundant converging loop (stands in for, e.g., a CMB
    transfer-function computation)."""
    def body(_, c):
        return c * 0.5 + jnp.sum(theta_slow**2) * 0.5
    r2_slow = jax.lax.fori_loop(0, 200, body, jnp.sum(theta_slow**2))
    return {"logL_slow": -r2_slow / (2 * SIGMA**2)}


def fast_part(aux, theta):
    r2_fast = jnp.sum(theta[N_SLOW:] ** 2)
    norm = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
    return norm + aux["logL_slow"] - r2_fast / (2 * SIGMA**2), [r2_fast]


GRADED = GradedLikelihood(heavy_slow, fast_part, N_SLOW)


def run_graded(tmp_path, **kw):
    defaults = dict(
        nDerived=1,
        prior=UniformPrior(-1, 1),
        nlive=80,
        num_repeats=4,
        grade_dims=[N_SLOW, N_FAST],
        grade_frac=[0.25, 0.75],
        read_resume=False,
        base_dir=str(tmp_path),
        file_root="g",
        seed=4,
        feedback=0,
        precision_criterion=0.01,
    )
    defaults.update(kw)
    return polychordlite_tpu.run(GRADED, NDIMS, **defaults)


class TestGradedLikelihood:
    def test_full_call_contract(self):
        """GradedLikelihood() as a plain callable = fast(slow(.), .)."""
        theta = jnp.asarray([0.1, -0.2, 0.3, 0.05])
        logL, phi = GRADED(theta)
        r2s = float(jnp.sum(theta[:N_SLOW] ** 2))
        r2f = float(jnp.sum(theta[N_SLOW:] ** 2))
        norm = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
        assert abs(float(logL) - (norm - (r2s + r2f) / 2 / SIGMA**2)) < 1e-4

    def test_calc_attaches_graded_paths(self):
        from polychordlite_tpu.ops.evaluate import make_batched_calculator

        calc = make_batched_calculator(lambda c: c, GRADED, NDIMS, 1)
        assert calc.graded and calc.n_slow == N_SLOW
        cube = jnp.full((8, NDIMS), 0.45)
        aux = calc.slow_aux_batch(cube)
        t1, p1, l1 = calc.fast_point_batch(aux, cube)
        t2, p2, l2 = calc(cube)
        np.testing.assert_allclose(np.asarray(l1), np.asarray(l2), rtol=1e-5)
        # out-of-cube probes are logzero without consulting aux
        bad = cube.at[:, -1].set(1.5)
        _, _, lbad = calc.fast_point_batch(aux, bad)
        assert (np.asarray(lbad) < -1e29).all()

    def test_resolve_engine_forces_scan(self):
        from polychordlite_tpu.core.nested_sampling import resolve_engine

        assert resolve_engine("auto", graded=True) == "scan"
        # a forced non-scan engine is overridden loudly, not silently
        with pytest.warns(UserWarning, match="scan"):
            assert resolve_engine("ring", graded=True) == "scan"

    def test_grade_dims_must_match_n_slow(self, tmp_path):
        """grade_dims[0] != n_slow would let fast chords move a slow
        parameter against a stale cached intermediate — rejected at setup."""
        with pytest.raises(ValueError, match="n_slow"):
            run_graded(tmp_path, grade_dims=[1, 3], grade_frac=[0.25, 0.75])

    def test_time_speeds_measures_real_ratio(self):
        from polychordlite_tpu.core.generate import time_speeds
        from polychordlite_tpu.ops.evaluate import make_batched_calculator
        from polychordlite_tpu.settings import PolyChordSettings

        calc = make_batched_calculator(lambda c: c, GRADED, NDIMS, 1)
        s = PolyChordSettings(
            NDIMS, 1, grade_dims=[N_SLOW, N_FAST], grade_frac=[0.25, 0.75]
        ).finalise()
        speeds = time_speeds(calc, s, jax.random.PRNGKey(0))
        # the slow path must measure genuinely slower than the fast path
        assert speeds[0] > 2.0 * speeds[1], speeds

    def test_end_to_end_accuracy_and_nlike_split(self, tmp_path):
        out = run_graded(tmp_path)
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.15
        # nlike per grade from the stats file: the slow grade must have
        # done a small fraction of the evals (it gets 1 of ~13 repeats
        # after speed apportioning; without decomposition every eval
        # would pay the slow cost)
        stats = open(str(tmp_path / "g.stats")).read()
        nlike_line = [
            line for line in stats.splitlines() if line.startswith(" nlike:")
        ][0]
        counts = [int(x) for x in nlike_line.split()[1:]]
        assert len(counts) == 2
        assert counts[0] > 0 and counts[1] > 0
        assert counts[0] < 0.35 * (counts[0] + counts[1]), counts

    def test_matches_monolithic_statistics(self, tmp_path):
        """The graded run's evidence agrees with the monolithic form of the
        same likelihood (different RNG path -> compare within errors)."""
        def mono(theta):
            r2 = jnp.sum(theta**2)
            norm = -NDIMS * (math.log(SIGMA) + 0.5 * math.log(2 * math.pi))
            return norm - r2 / (2 * SIGMA**2), [jnp.sum(theta[N_SLOW:] ** 2)]

        out_g = run_graded(tmp_path / "a")
        out_m = polychordlite_tpu.run(
            mono,
            NDIMS,
            nDerived=1,
            prior=UniformPrior(-1, 1),
            nlive=80,
            num_repeats=4,
            read_resume=False,
            base_dir=str(tmp_path / "b"),
            file_root="m",
            seed=4,
            feedback=0,
            precision_criterion=0.01,
        )
        err = math.hypot(out_g.logZerr, out_m.logZerr)
        assert abs(out_g.logZ - out_m.logZ) < 3 * err + 0.1
