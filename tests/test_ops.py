"""Unit tests for the numerics substrate (logspace, linalg, priors,
directions) — the per-module coverage the reference lacks (SURVEY §4)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polychordlite_tpu.ops import logspace
from polychordlite_tpu.ops.linalg import (
    calc_cholesky_np,
    calc_covmat_np,
    similarity_matrix_np,
)
from polychordlite_tpu.ops.directions import make_directions
from polychordlite_tpu import priors


class TestLogspace:
    def test_logsumexp_matches_naive(self):
        a = np.array([-1.0, 0.5, 2.0])
        got = logspace.logsumexp(np, a)
        assert np.isclose(got, np.log(np.sum(np.exp(a))))

    def test_logsumexp_all_logzero(self):
        a = np.full(4, logspace.LOG_ZERO)
        assert logspace.logsumexp(np, a) == logspace.LOG_ZERO

    def test_logaddexp_with_logzero(self):
        assert np.isclose(logspace.logaddexp(np, 1.3, logspace.LOG_ZERO), 1.3)
        assert (
            logspace.logaddexp(np, logspace.LOG_ZERO, logspace.LOG_ZERO)
            == logspace.LOG_ZERO
        )

    def test_logsubexp(self):
        a, b = 2.0, 1.0
        got = logspace.logsubexp(np, a, b)
        assert np.isclose(got, np.log(np.exp(a) - np.exp(b)))

    def test_logincexp_accumulates(self):
        acc = logspace.LOG_ZERO
        for x in [0.0, 1.0, -3.0]:
            acc = logspace.logincexp(np, acc, x)
        assert np.isclose(acc, np.log(np.exp(0.0) + np.exp(1.0) + np.exp(-3.0)))

    def test_jax_backend_agrees(self):
        a = np.linspace(-3, 4, 7)
        np_val = logspace.logsumexp(np, a)
        jx_val = logspace.logsumexp(jnp, jnp.asarray(a))
        assert np.isclose(np_val, float(jx_val), atol=1e-4)  # f32 device path


class TestLinalg:
    def test_cholesky_roundtrip(self):
        rng = np.random.default_rng(0)
        A = rng.standard_normal((5, 5))
        cov = A @ A.T + 0.1 * np.eye(5)
        L = calc_cholesky_np(cov)
        assert np.allclose(L @ L.T, cov)

    def test_cholesky_degenerate_fallback(self):
        # Not positive definite -> sqrt(trace/D) * identity (utils.F90:634-637)
        cov = np.array([[1.0, 2.0], [2.0, 1.0]])  # eigenvalues 3, -1
        L = calc_cholesky_np(cov)
        assert np.allclose(L, np.eye(2) * np.sqrt(np.trace(cov) / 2))

    def test_covmat_population_normalised(self):
        pts = np.array([[0.0, 0.0], [2.0, 2.0]])
        cov = calc_covmat_np(pts)
        assert np.allclose(cov, np.ones((2, 2)))  # var = 1 with 1/n norm

    def test_similarity_matrix(self):
        pts = np.random.default_rng(1).standard_normal((6, 3))
        sim = similarity_matrix_np(pts)
        brute = ((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1)
        assert np.allclose(sim, brute, atol=1e-10)


class TestPriors:
    def test_uniform(self):
        p = priors.UniformPrior(-1.0, 1.0)
        x = np.array([0.0, 0.5, 1.0])
        assert np.allclose(np.asarray(p(x)), [-1.0, 0.0, 1.0])

    def test_gaussian_median(self):
        p = priors.GaussianPrior(3.0, 2.0)
        assert np.isclose(float(p(jnp.array(0.5))), 3.0, atol=1e-6)

    def test_vector_bounds_unroll_to_literals(self):
        """Vector-parameter priors carry NO array constants (they unroll to
        per-coordinate literals) and match per-coordinate arithmetic on
        both (D,) and block (D, ...) inputs."""
        p = priors.UniformPrior([-6.0, -2.5], [6.0, 2.5])
        x = np.array([0.5, 1.0])
        assert np.allclose(np.asarray(p(x)), [0.0, 2.5])
        tile = np.full((2, 3, 4), 0.5)
        out = np.asarray(p(tile))
        assert out.shape == (2, 3, 4)
        assert np.allclose(out[0], 0.0) and np.allclose(out[1], 0.0)
        # closure constants: tracing must produce a jaxpr with no consts
        import jax

        jaxpr = jax.make_jaxpr(p)(jnp.zeros(2))
        assert not jaxpr.consts, jaxpr.consts

        g = priors.GaussianPrior([0.0, 1.0], [1.0, 2.0])
        v = np.asarray(g(np.array([0.5, 0.5])))
        assert np.allclose(v, [0.0, 1.0], atol=1e-5)
        assert not jax.make_jaxpr(g)(jnp.zeros(2)).consts

        lu = priors.LogUniformPrior([1.0, 10.0], [100.0, 1000.0])
        v = np.asarray(lu(np.array([0.5, 0.5])))
        assert np.allclose(v, [10.0, 100.0], rtol=1e-5)
        assert not jax.make_jaxpr(lu)(jnp.zeros(2)).consts

    def test_vector_bounds_broadcast_scalar(self):
        p = priors.UniformPrior(0.0, [1.0, 2.0])
        assert np.allclose(np.asarray(p(np.array([0.5, 0.5]))), [0.5, 1.0])
        with pytest.raises(ValueError):
            priors.UniformPrior([0.0, 1.0], [1.0, 2.0, 3.0])

    def test_forced_identifiability_sorted(self):
        rng = np.random.default_rng(2)
        x = rng.uniform(size=20)
        t = np.asarray(priors.forced_identifiability_transform(x))
        assert np.all(np.diff(t) >= 0)
        assert np.all((t >= 0) & (t <= 1))

    def test_forced_identifiability_matches_reference_recurrence(self):
        # Sequential recurrence from pypolychord/priors.py:29-35
        x = np.random.default_rng(3).uniform(size=8)
        N = len(x)
        t_ref = np.zeros(N)
        t_ref[N - 1] = x[N - 1] ** (1.0 / N)
        for n in range(N - 2, -1, -1):
            t_ref[n] = x[n] ** (1.0 / (n + 1)) * t_ref[n + 1]
        t = np.asarray(priors.forced_identifiability_transform(x))
        assert np.allclose(t, t_ref, atol=1e-4)  # f32 device path

    def test_block_system_uniform_gaussian(self):
        blocks = [
            priors.PriorBlock("uniform", (0, 1), (0, 1), (-2.0, 2.0)),
            priors.PriorBlock("gaussian", (2,), (2,), (1.0, 0.5)),
        ]
        cube = jnp.array([0.5, 0.25, 0.5])
        theta = np.asarray(priors.hypercube_to_physical(cube, blocks))
        assert np.allclose(theta, [0.0, -1.0, 1.0], atol=1e-6)
        # round trip for invertible types
        back = np.asarray(priors.physical_to_hypercube(jnp.asarray(theta), blocks))
        assert np.allclose(back, np.asarray(cube), atol=1e-6)

    def test_sorted_uniform_block_roundtrip(self):
        blocks = [priors.PriorBlock("sorted_uniform", (0, 1, 2), (0, 1, 2), (0.0, 1.0))]
        cube = jnp.array([0.3, 0.9, 0.6])
        theta = priors.hypercube_to_physical(cube, blocks)
        assert np.all(np.diff(np.asarray(theta)) >= 0)
        back = priors.physical_to_hypercube(theta, blocks)
        assert np.allclose(np.asarray(back), np.asarray(cube), atol=1e-5)

    def test_adaptive_sorted_uniform(self):
        blocks = [
            priors.PriorBlock(
                "adaptive_sorted_uniform", tuple(range(5)), tuple(range(5)), (0.0, 0.0, 0.0, 1.0)
            )
        ]
        cube = jnp.array([0.9, 0.8, 0.2, 0.7, 0.1])
        theta = np.asarray(priors.hypercube_to_physical(cube, blocks))
        nfunc = int(np.floor(0.5 + cube[0] * 4 + 0.5))
        # the first nfunc post-adaptive coords are sorted
        assert np.all(np.diff(theta[1 : nfunc + 1]) >= 0)

    def test_prior_log_volume(self):
        blocks = [priors.PriorBlock("uniform", (0, 1), (0, 1), (-1.0, 1.0))]
        assert np.isclose(priors.prior_log_volume(blocks), 2 * math.log(2.0))


class TestDirections:
    def test_shapes_norms_and_grades(self):
        B, D = 4, 6
        grade_dims = (2, 4)
        num_repeats = (3, 5)
        key = jax.random.PRNGKey(0)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(B))
        chol = jnp.broadcast_to(jnp.eye(D), (B, D, D))
        nhats, w, speeds = make_directions(
            keys, chol, grade_dims=grade_dims, num_repeats=num_repeats, n_dims=D
        )
        R = sum(num_repeats)
        assert nhats.shape == (B, R, D)
        norms = np.linalg.norm(np.asarray(nhats), axis=-1)
        assert np.allclose(norms, 1.0, atol=1e-2)
        assert np.allclose(np.asarray(w), 3.0, atol=3e-2)  # identity cholesky
        sp = np.asarray(speeds)
        # first slot is always slow (grade 0), chordal_sampling.f90:132-137
        assert np.all(sp[:, 0] == 0)
        assert np.all(np.sort(sp, axis=1)[:, : num_repeats[0]] == 0)

    def test_fast_directions_leave_slow_dims_untouched(self):
        B, D = 3, 5
        grade_dims = (2, 3)
        num_repeats = (2, 4)
        key = jax.random.PRNGKey(1)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(B))
        rng = np.random.default_rng(0)
        A = rng.standard_normal((D, D))
        cov = A @ A.T + np.eye(D)
        L = np.linalg.cholesky(cov)
        chol = jnp.broadcast_to(jnp.asarray(L, dtype=jnp.float32), (B, D, D))
        nhats, w, speeds = make_directions(
            keys, chol, grade_dims=grade_dims, num_repeats=num_repeats, n_dims=D
        )
        nh, sp = np.asarray(nhats), np.asarray(speeds)
        # fast-grade chords must not move the slow coordinates (lower-
        # triangular whitening, chordal_sampling.f90:73 + grade layout)
        fast = sp == 1
        assert np.allclose(nh[fast][:, : grade_dims[0]], 0.0, atol=1e-6)

    def test_whitening_scales_width(self):
        B, D = 2, 3
        key = jax.random.PRNGKey(2)
        keys = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.arange(B))
        chol = jnp.broadcast_to(2.0 * jnp.eye(D), (B, D, D))
        _, w, _ = make_directions(
            keys, chol, grade_dims=(D,), num_repeats=(4,), n_dims=D
        )
        assert np.allclose(np.asarray(w), 6.0, atol=6e-2)
