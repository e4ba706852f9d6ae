"""End-to-end integration tests, modelled on the reference suite
(``tests/test_run_pypolychord.py``): analytic-logZ oracle, seed-determinism
contract, derived-parameter plumbing, grade_dims validation, resume."""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest

import polychordlite_tpu
from polychordlite_tpu.priors import UniformPrior

SIGMA = 0.1
NDIMS = 2
ANALYTIC_LOGZ = -NDIMS * math.log(2)  # normalised gaussian over U[-1,1]^D


def gaussian_likelihood(theta):
    r2 = jnp.sum(theta**2)
    logL = -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0 - r2 / 2 / SIGMA**2
    return logL, [r2]


def run_small(tmp_path, file_root="t", seed=1, **kw):
    defaults = dict(
        nDerived=1,
        prior=UniformPrior(-1, 1),
        nlive=60,
        num_repeats=2 * NDIMS,
        read_resume=False,
        base_dir=str(tmp_path),
        file_root=file_root,
        seed=seed,
        feedback=0,
        precision_criterion=0.01,
    )
    defaults.update(kw)
    return polychordlite_tpu.run(gaussian_likelihood, NDIMS, **defaults)


class TestEndToEnd:
    def test_logZ_matches_analytic(self, tmp_path):
        out = run_small(tmp_path)
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.1
        assert out.ndead > 100
        assert out.nlike > 0

    def test_output_files_exist(self, tmp_path):
        out = run_small(tmp_path, file_root="files")
        root = os.path.join(str(tmp_path), "files")
        for suffix in (
            ".stats",
            ".txt",
            "_equal_weights.txt",
            "_dead.txt",
            "_dead-birth.txt",
            "_phys_live.txt",
            "_phys_live-birth.txt",
            "_prior.txt",
            ".resume",
            ".properties.ini",
        ):
            assert os.path.exists(root + suffix), suffix

    def test_metrics_jsonl_stream(self, tmp_path):
        """SURVEY §5.1/§5.5: structured metrics with the reference's cost
        accounting (evals/s, device-time fraction) per compression e-fold."""
        import json

        run_small(tmp_path, file_root="met")
        path = os.path.join(str(tmp_path), "met.metrics.jsonl")
        assert os.path.exists(path)
        recs = [json.loads(line) for line in open(path)]
        assert len(recs) >= 2
        for k in (
            "t", "ndead", "nlive", "ncluster", "logZ", "logZerr",
            "nlike", "evals_per_s", "dead_per_s", "device_frac", "epochs",
        ):
            assert k in recs[0], k
        ndead = [r["ndead"] for r in recs]
        assert ndead == sorted(ndead) and ndead[-1] > 100
        nlike = [r["nlike"] for r in recs]
        assert nlike == sorted(nlike)  # cumulative
        assert all(0.0 <= r["device_frac"] <= 1.0 for r in recs)
        assert recs[-1]["nlive"] == 0  # final record after the live-point drain

    def test_equal_weights_file_parses(self, tmp_path):
        out = run_small(tmp_path, file_root="eq")
        data = np.loadtxt(os.path.join(str(tmp_path), "eq_equal_weights.txt"))
        assert data.shape[1] == 2 + NDIMS + 1  # weight, -2logL, params, derived
        assert np.allclose(data[:, 0], 1.0)
        # posterior mean of theta should be near 0 (the gaussian is at 0)
        assert np.all(np.abs(data[:, 2 : 2 + NDIMS].mean(0)) < 0.05)

    def test_dead_birth_contours(self, tmp_path):
        run_small(tmp_path, file_root="db")
        data = np.loadtxt(os.path.join(str(tmp_path), "db_dead-birth.txt"))
        logL, birth = data[:, -2], data[:, -1]
        assert np.all(birth <= logL + 1e-6)

    def test_dumper_called(self, tmp_path):
        calls = []

        def dumper(live, dead, logweights, logZ, logZerr):
            calls.append((live.shape, dead.shape, logweights.shape, logZ))

        run_small(tmp_path, file_root="dump", dumper=dumper)
        assert len(calls) > 2
        live_shape, dead_shape, lw_shape, logZ = calls[-1]
        assert live_shape[1] == NDIMS + 1 + 2  # params, derived, birth, logL
        assert dead_shape[0] == lw_shape[0]
        assert np.isfinite(logZ)


class TestRunOptions:
    def test_nlives_schedule(self, tmp_path):
        """Variable-nlive schedule (run_time_info.f90:716-787 nlives/loglikes):
        the live population must track the schedule as the contour rises."""
        import json

        run_small(tmp_path, file_root="sched", nlive=60, nlives={-20.0: 25})
        recs = [
            json.loads(l)
            for l in open(os.path.join(str(tmp_path), "sched.metrics.jsonl"))
        ]
        lives = [r["nlive"] for r in recs[:-1]]
        assert max(lives) > 25  # starts at ~60
        assert min(lives) <= 30  # shrinks toward the scheduled 25

    def test_boost_posterior_enriches_samples(self, tmp_path):
        """boost_posterior keeps phantom points as posterior samples
        (clean_phantoms / thin_posterior, run_time_info.f90:820-877)."""
        run_small(tmp_path, file_root="b0", boost_posterior=0.0)
        run_small(tmp_path, file_root="b5", boost_posterior=5.0)
        n0 = len(np.loadtxt(os.path.join(str(tmp_path), "b0.txt")))
        n5 = len(np.loadtxt(os.path.join(str(tmp_path), "b5.txt")))
        assert n5 > 1.5 * n0


class TestMaximiser:
    def test_maximise_writes_maximum_file(self, tmp_path):
        """settings%maximise: post-run Nelder-Mead finds the gaussian peak
        and writes <root>.maximum (maximiser.F90:33-87)."""
        run_small(tmp_path, file_root="mx", maximise=True)
        path = os.path.join(str(tmp_path), "mx.maximum")
        assert os.path.exists(path)
        text = open(path).read()
        assert "log-likelihood" in text.lower() or "loglike" in text.lower()
        # the max-likelihood physical point should be near the peak at 0
        nums = []
        for line in text.splitlines():
            try:
                nums.append([float(x) for x in line.split()])
            except ValueError:
                continue
        nums = [r for r in nums if r]
        assert nums, text
        # some numeric row holds the physical coordinates near the origin
        near0 = any(
            len(r) >= NDIMS and all(abs(v) < 0.05 for v in r[:NDIMS]) for r in nums
        )
        assert near0, nums


    def test_posterior_mode_dispatch_batching(self):
        """Posterior-mode evaluations fuse the point and all its Jacobian
        probes into ONE device call; the whole simplex is one call too
        (maximiser.F90:33-87 analogue of the batched likelihood mode)."""
        import jax.numpy as jnp

        from polychordlite_tpu.core.maximiser import _logP_batch
        from polychordlite_tpu.ops.evaluate import make_batched_calculator
        from polychordlite_tpu.priors import UniformPrior
        from polychordlite_tpu.settings import PolyChordSettings

        prior = UniformPrior(-2.0, 2.0)

        def like(theta):
            return -jnp.sum(theta**2) * 5.0

        calls = {"n": 0}
        calc0 = make_batched_calculator(prior, like, 4, 0)

        def counting(cube):
            calls["n"] += 1
            return calc0(cube)

        counting.n_phi = calc0.n_phi
        s = PolyChordSettings(4, 0).finalise()
        cubes = np.full((5, 4), 0.5) + 0.01 * np.arange(20).reshape(5, 4)
        logP, pts, dX = _logP_batch(counting, s, cubes)
        assert calls["n"] == 1, "simplex + Jacobians must be a single dispatch"
        assert logP.shape == (5,) and dX.shape == (5,)
        # Jacobian of UniformPrior(-2,2) is 4 per coord -> logdet = 4*log 4
        assert np.allclose(-dX, 4 * math.log(4.0), atol=2e-2)
        # logP = logL - logdet
        assert np.allclose(logP, pts[:, s.l0] - 4 * math.log(4.0), atol=2e-2)



class TestSeedDeterminism:
    @pytest.mark.parametrize("seed", [1, 2])
    def test_same_seed_identical(self, tmp_path, seed):
        run_small(tmp_path / "a", file_root="s", seed=seed)
        run_small(tmp_path / "b", file_root="s", seed=seed)
        a = np.loadtxt(str(tmp_path / "a" / "s_dead-birth.txt"))
        b = np.loadtxt(str(tmp_path / "b" / "s_dead-birth.txt"))
        assert a.shape == b.shape
        assert np.array_equal(a, b)

    def test_different_seed_differs(self, tmp_path):
        run_small(tmp_path / "a", file_root="s", seed=1)
        run_small(tmp_path / "b", file_root="s", seed=2)
        a = np.loadtxt(str(tmp_path / "a" / "s_dead-birth.txt"))
        b = np.loadtxt(str(tmp_path / "b" / "s_dead-birth.txt"))
        assert a.shape != b.shape or not np.array_equal(a, b)


class TestApiParity:
    def test_no_derived(self, tmp_path):
        def no_derived(theta):
            r2 = jnp.sum(theta**2)
            return (
                -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0
                - r2 / 2 / SIGMA**2
            )

        out = polychordlite_tpu.run(
            no_derived,
            NDIMS,
            prior=UniformPrior(-1, 1),
            nlive=50,
            num_repeats=NDIMS * 2,
            read_resume=False,
            base_dir=str(tmp_path),
            seed=1,
            feedback=0,
            precision_criterion=0.05,
        )
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.2

    def test_grade_dims_validation(self, tmp_path):
        with pytest.raises(ValueError):
            polychordlite_tpu.run(
                gaussian_likelihood,
                5,
                nDerived=1,
                grade_dims=[1, 3],
                base_dir=str(tmp_path),
                feedback=0,
            )

    def test_unknown_kwarg_rejected(self, tmp_path):
        with pytest.raises(TypeError):
            polychordlite_tpu.run(
                gaussian_likelihood, NDIMS, not_a_setting=True
            )

    def test_legacy_interface(self, tmp_path):
        from polychordlite_tpu import PolyChordSettings, run_polychord

        settings = PolyChordSettings(NDIMS, 1)
        settings.nlive = 50
        settings.num_repeats = 2 * NDIMS
        settings.read_resume = False
        settings.feedback = 0
        settings.base_dir = str(tmp_path)
        settings.file_root = "legacy"
        settings.seed = 3
        settings.precision_criterion = 0.05
        out = run_polychord(
            gaussian_likelihood, NDIMS, 1, settings, UniformPrior(-1, 1)
        )
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.2

    def test_numpy_likelihood_callback_path(self, tmp_path):
        def np_like(theta):
            theta = np.asarray(theta)
            r2 = float((theta**2).sum())
            return (
                -math.log(2 * math.pi * SIGMA * SIGMA) * NDIMS / 2.0
                - r2 / 2 / SIGMA**2,
                [r2],
            )

        out = polychordlite_tpu.run(
            np_like,
            NDIMS,
            nDerived=1,
            prior=lambda c: np.asarray(-1 + 2 * np.asarray(c)),
            nlive=40,
            num_repeats=NDIMS * 2,
            read_resume=False,
            base_dir=str(tmp_path),
            seed=1,
            feedback=0,
            precision_criterion=0.05,
        )
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.3

    def test_cube_samples(self, tmp_path):
        cube = np.array([[0.1, 0.2], [0.5, 0.6], [0.4, 0.5], [0.52, 0.48]])
        out = run_small(
            tmp_path, file_root="cube", cube_samples=cube, nlive=40
        )
        assert np.isfinite(out.logZ)


class TestResume:
    def test_resume_continues_run(self, tmp_path):
        # First: a capped run that stops early and writes a resume file
        out1 = run_small(
            tmp_path, file_root="res", max_ndead=150, read_resume=False
        )
        assert out1.ndead >= 150
        # Second: resume and run to completion
        out2 = run_small(
            tmp_path, file_root="res", read_resume=True, max_ndead=-1
        )
        assert out2.ndead > out1.ndead
        assert abs(out2.logZ - ANALYTIC_LOGZ) < 3 * out2.logZerr + 0.2

    def test_resume_dimension_mismatch_rejected(self, tmp_path):
        run_small(tmp_path, file_root="mm", max_ndead=100, read_resume=False)
        from polychordlite_tpu.settings import PolyChordSettings
        from polychordlite_tpu.utils import resume as resume_mod

        s = PolyChordSettings(NDIMS + 1, 0, num_repeats=4)
        s.base_dir = str(tmp_path)
        s.file_root = "mm"
        s.finalise()
        with pytest.raises(ValueError):
            resume_mod.read_resume_file(s, 1)


def test_fancy_feedback_prints_cluster_table(tmp_path, capsys):
    """feedback=2 prints the per-cluster evidence table each update
    (reference fancy mode, feedback.f90 / utils.F90:22-26)."""
    run_small(tmp_path, feedback=2, max_ndead=150)
    out = capsys.readouterr().out
    assert "cluster |" in out and "log(Z_p)" in out
    assert "logX_p" in out


class TestEngineDefault:
    """The public API hands users one engine: run() defaults to
    engine="auto", which resolves to the scan engine on every backend (one
    hot-path story, reference nested_sampling.F90:259)."""

    def test_run_default_engine_is_auto(self):
        import importlib
        import inspect

        run_mod = importlib.import_module("polychordlite_tpu.run")
        src = inspect.getsource(run_mod.run)
        assert '"engine": "auto"' in src

    @pytest.mark.parametrize(
        "engine, resolved", [("auto", "scan"), ("scan", "scan"), ("ring", "ring")]
    )
    def test_resolve_engine_gpu_is_scan(self, monkeypatch, engine, resolved):
        import jax

        from polychordlite_tpu.core.nested_sampling import resolve_engine

        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert resolve_engine(engine) == resolved

    @pytest.mark.parametrize(
        "name", ["pallas", "pallas2", "pallas3", "pallas4", "pallas5", "fused"]
    )
    def test_removed_engine_names_raise(self, name):
        from polychordlite_tpu.core.nested_sampling import resolve_engine
        from polychordlite_tpu.ops.evaluate import make_batched_calculator
        from polychordlite_tpu.ops.slice_kernel import (
            EpochConfig,
            build_epoch_fn,
        )

        with pytest.raises(ValueError, match="scan.*ring"):
            resolve_engine(name)
        calc = make_batched_calculator(
            lambda c: c, lambda t: -jnp.sum(t**2), 2, 0
        )
        cfg = EpochConfig(n_dims=2, n_phi=1, grade_dims=(2,),
                          num_repeats=(2,), engine=name)
        with pytest.raises(ValueError, match="scan.*ring"):
            build_epoch_fn(calc, cfg)

    def test_run_with_removed_engine_raises(self, tmp_path):
        with pytest.raises(ValueError, match="unknown slice engine"):
            run_small(tmp_path, engine="pallas", max_ndead=10)

    def test_resolve_engine_cpu_is_scan(self):
        from polychordlite_tpu.core.nested_sampling import resolve_engine

        assert resolve_engine("auto") == "scan"

    def test_settings_default_engine_auto(self):
        from polychordlite_tpu.settings import PolyChordSettings

        assert PolyChordSettings(4, 0).engine == "auto"


class TestAsyncStaleness:
    """Dispatch-ahead (asynchronous) mode carries a small measured logZ
    bias at ANY width (64-seed calibration,
    benchmarks/calibration_study.json: async +0.25 to +0.32 pull,
    width-independent; sync unbiased) — async warns once at run start and
    uses the same B=nlive default as sync (the old nlive/4 fence did not
    reduce the bias and is removed)."""

    def test_batch_default_is_nlive_in_both_modes(self):
        from polychordlite_tpu.settings import PolyChordSettings

        s = PolyChordSettings(4, 0, nlive=200, synchronous=False)
        assert s.resolved_batch_size() == 200
        s_sync = PolyChordSettings(4, 0, nlive=200, synchronous=True)
        assert s_sync.resolved_batch_size() == 200

    def test_async_warns_about_bias(self, tmp_path):
        import warnings

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            run_small(
                tmp_path, file_root="aw", synchronous=False, max_ndead=120,
            )
        assert any("biases logZ high" in str(x.message) for x in w)

    def test_sync_does_not_warn_about_bias(self, tmp_path):
        import warnings

        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            run_small(tmp_path, file_root="sw", max_ndead=120)
        assert not any("biases logZ high" in str(x.message) for x in w)

    def test_async_default_run_accurate(self, tmp_path):
        out = run_small(tmp_path, file_root="ad", synchronous=False)
        assert abs(out.logZ - ANALYTIC_LOGZ) < 3 * out.logZerr + 0.15
