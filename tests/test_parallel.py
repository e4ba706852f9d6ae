"""Mesh-sharding contracts: multi-device epochs must be bitwise identical to
single-device ones, and speed grades must run end-to-end."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import polychordlite_tpu
from polychordlite_tpu.ops.evaluate import make_batched_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig
from polychordlite_tpu.parallel.mesh import make_epoch_runner
from polychordlite_tpu.priors import UniformPrior


def _setup(n_dims=4, num_repeats=(6,), grade_dims=None):
    def loglike(theta):
        return -jnp.sum((theta - 0.5) ** 2) * 40.0

    calc = make_batched_calculator(lambda c: c, loglike, n_dims, 1)
    cfg = EpochConfig(
        n_dims=n_dims,
        n_phi=calc.n_phi,
        grade_dims=tuple(grade_dims or (n_dims,)),
        num_repeats=tuple(num_repeats),
    )
    return calc, cfg


@pytest.mark.slow  # multi-device bitwise sweeps, ~25 s
class TestShardInvariance:
    def test_multi_device_matches_single(self):
        assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
        calc, cfg = _setup()
        B = 64
        key = jax.random.PRNGKey(0)
        seeds = np.full((B, 4), 0.5)
        bound = np.full((B,), -2.0)
        chol = np.broadcast_to(0.05 * np.eye(4), (B, 4, 4))

        run1, B1 = make_epoch_runner(calc, cfg, B, single_device=True)
        run8, B8 = make_epoch_runner(calc, cfg, B, devices=jax.devices()[:8])
        assert B1 == B8 == B
        out1 = run1(key, seeds, bound, chol)
        out8 = run8(key, seeds, bound, chol)
        for a, b in zip(out1, out8):
            assert np.array_equal(a, b), "sharding changed the results"

    def test_two_vs_four_devices_identical(self):
        calc, cfg = _setup()
        B = 32
        key = jax.random.PRNGKey(3)
        seeds = np.full((B, 4), 0.5)
        bound = np.full((B,), -2.0)
        chol = np.broadcast_to(0.05 * np.eye(4), (B, 4, 4))
        run2, _ = make_epoch_runner(calc, cfg, B, devices=jax.devices()[:2])
        run4, _ = make_epoch_runner(calc, cfg, B, devices=jax.devices()[:4])
        for a, b in zip(run2(key, seeds, bound, chol), run4(key, seeds, bound, chol)):
            assert np.array_equal(a, b)


class TestSpeedGrades:
    def test_multi_grade_end_to_end(self, tmp_path):
        """grade_dims=[2,2] with explicit per-grade repeats (grade_frac > 1
        means literal repeat counts, generate.F90:304-309)."""
        sigma = 0.2

        def loglike(theta):
            r2 = jnp.sum(theta**2)
            return -math.log(2 * math.pi * sigma**2) * 2.0 - r2 / 2 / sigma**2

        out = polychordlite_tpu.run(
            loglike,
            4,
            prior=UniformPrior(-1, 1),
            nlive=60,
            num_repeats=4,
            grade_dims=[2, 2],
            grade_frac=[2.0, 6.0],
            read_resume=False,
            base_dir=str(tmp_path),
            seed=2,
            feedback=0,
            precision_criterion=0.02,
            equals=False,
            posteriors=False,
        )
        analytic = -4 * math.log(2)
        assert abs(out.logZ - analytic) < 2 * out.logZerr + 0.15
        # both grades must have recorded likelihood calls, slow fewer than
        # fast (2 vs 6 repeats)
        stats = open(str(tmp_path / "test.stats")).read()
        nlike_line = [l for l in stats.splitlines() if l.startswith(" nlike:")][0]
        counts = [int(x) for x in nlike_line.split()[1:]]
        assert len(counts) == 2
        assert counts[0] > 0 and counts[1] > 0
        assert counts[1] > counts[0]


class TestDistributedHelpers:
    def test_single_host_defaults(self):
        from polychordlite_tpu.parallel.distributed import (
            initialise_distributed,
            is_root,
        )

        assert initialise_distributed() == 0
        assert is_root()


class TestEngineObservability:
    """No demotion: a failure of the requested engine raises, and
    engine_used() reports the engine that executed."""

    def test_engine_used_reports_built_engine(self):
        calc, cfg = _setup()
        runner, B = make_epoch_runner(calc, cfg, 16, single_device=True)
        assert runner.engine_used() == "scan"
        assert runner.ring_reruns() == 0

    @pytest.mark.parametrize("where", ["dispatch", "collect"])
    def test_ring_engine_failure_raises_without_demotion(self, where):
        """A failing ring engine raises at dispatch or at collect; the run
        does not fall back to the scan engine, then or on the next call."""
        calc, cfg = _setup()
        cfg = cfg._replace(engine="ring")
        runner, B = make_epoch_runner(calc, cfg, 16, single_device=True)
        key = jax.random.PRNGKey(0)
        seeds = np.full((B, 4), 0.5)
        bound = np.full((B,), -2.0)
        chol = np.broadcast_to(0.05 * np.eye(4), (B, 4, 4))

        class Unfetchable:
            def __array__(self, *a, **k):
                raise RuntimeError("forced engine failure")

        def boom(key, packed):
            if where == "dispatch":
                raise RuntimeError("forced engine failure")
            return Unfetchable()

        runner._engines["current"] = boom
        import warnings as _w

        for _ in range(2):
            with _w.catch_warnings():
                _w.simplefilter("error")
                with pytest.raises(RuntimeError, match="forced"):
                    runner(key, seeds, bound, chol)
        assert runner.engine_used() == "ring"
        assert "scan" not in runner._engines

    def test_scan_engine_failure_raises(self):
        calc, cfg = _setup()
        runner, B = make_epoch_runner(calc, cfg, 16, single_device=True)

        def boom(key, packed):
            raise RuntimeError("forced engine failure")

        runner._engines["current"] = boom
        key = jax.random.PRNGKey(0)
        seeds = np.full((B, 4), 0.5)
        with pytest.raises(RuntimeError, match="forced"):
            runner(key, seeds, np.full((B,), -2.0),
                   np.broadcast_to(0.05 * np.eye(4), (B, 4, 4)))
