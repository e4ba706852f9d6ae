"""Slice-engine correctness: uniformity within a known contour, determinism,
nlike accounting (the slice-sampler oracle from SURVEY §4)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from polychordlite_tpu.ops.evaluate import make_batched_calculator
from polychordlite_tpu.ops.logspace import LOG_ZERO
from polychordlite_tpu.ops.slice_kernel import (
    EpochConfig,
    build_epoch_fn,
    unpack_epoch,
)


def _make_epoch(n_dims, num_repeats, loglike, n_phi=1):
    calc = make_batched_calculator(
        prior_fn=lambda c: c, loglike_fn=loglike, n_dims=n_dims, n_derived=n_phi
    )
    cfg = EpochConfig(
        n_dims=n_dims,
        n_phi=calc.n_phi,
        grade_dims=(n_dims,),
        num_repeats=(num_repeats,),
    )
    jitted = jax.jit(build_epoch_fn(calc, cfg))

    def epoch(key, seeds, bounds, chol, valid):
        return unpack_epoch(jitted(key, seeds, bounds, chol, valid), cfg)

    return epoch, cfg


_STATE = {}


def _engine_state():
    """Compile the engine once and share it across the test class."""
    if _STATE:
        return _STATE
    D, R, B = 4, 16, 128

    def loglike(theta):
        return -jnp.sum((theta - 0.5) ** 2)

    epoch, cfg = _make_epoch(D, R, loglike)
    r0 = 0.3
    bound = -(r0**2)
    key = jax.random.PRNGKey(7)
    seeds = jnp.full((B, D), 0.5)
    bounds = jnp.full((B,), bound)
    chol = jnp.broadcast_to(jnp.eye(D), (B, D, D))
    valid = jnp.ones((B,), bool)
    out = epoch(key, seeds, bounds, chol, valid)
    _STATE.update(
        D=D,
        R=R,
        B=B,
        epoch=epoch,
        cfg=cfg,
        r0=r0,
        bound=bound,
        key=key,
        seeds=seeds,
        bounds=bounds,
        chol=chol,
        valid=valid,
        out=out,
    )
    return _STATE


class TestSliceEngine:
    def setup_method(self):
        for k, v in _engine_state().items():
            setattr(self, k, v)

    def test_all_babies_inside_contour(self):
        logL = np.asarray(self.out[3])
        assert logL.shape == (self.B, self.R)
        assert np.all(logL >= self.bound - 1e-5)

    def test_babies_uniform_in_ball(self):
        # For points uniform in a D-ball of radius r0: E[r^2] = r0^2 * D/(D+2)
        cube = np.asarray(self.out[0])  # (B, R, D)
        last = cube[:, -1, :]  # final baby of each chain (the new live point)
        r2 = ((last - 0.5) ** 2).sum(-1)
        expect = self.r0**2 * self.D / (self.D + 2)
        se = np.std(r2) / np.sqrt(self.B)
        assert abs(r2.mean() - expect) < 4 * se + 1e-4
        # u = (r/r0)^D should be Uniform(0,1): check first and second moments
        u = (np.sqrt(r2) / self.r0) ** self.D
        assert abs(u.mean() - 0.5) < 4 * (0.29 / np.sqrt(self.B))

    def test_deterministic(self):
        out2 = self.epoch(self.key, self.seeds, self.bounds, self.chol, self.valid)
        for a, b in zip(self.out, out2):
            assert np.array_equal(np.asarray(a), np.asarray(b))

    def test_nlike_positive_and_bounded(self):
        nlike = np.asarray(self.out[4])  # (B, n_grades)
        assert nlike.shape == (self.B, 1)
        assert np.all(nlike >= self.R)  # at least one eval per repeat

    def test_invalid_lanes_skipped(self):
        valid = self.valid.at[0].set(False)
        out = self.epoch(self.key, self.seeds, self.bounds, self.chol, valid)
        logL = np.asarray(out[3])
        nlike = np.asarray(out[4])
        assert np.all(logL[0] <= -1e29)  # LOG_ZERO through an f32 round-trip
        assert nlike[0].sum() == 0
        assert np.all(logL[1:] >= self.bound - 1e-5)

    def test_theta_and_derived_recorded(self):
        cube = np.asarray(self.out[0])
        theta = np.asarray(self.out[1])
        assert np.allclose(cube, theta, atol=1e-6)  # identity prior

    def test_chain_moves(self):
        cube = np.asarray(self.out[0])
        # consecutive babies differ (the chain actually moves)
        d = np.abs(cube[:, 1:] - cube[:, :-1]).sum(-1)
        assert np.all(d > 0)


class TestRingMatchesScan:
    """The ring engine (fused per-lane progress, window/ring memory layout)
    must produce bit-identical output to the scan-over-repeats oracle
    (counter-based RNG guarantees the per-(lane, repeat, iteration) streams
    coincide)."""

    def _compare(self, cfg_kwargs, key_seed=11):
        from polychordlite_tpu.ops.slice_kernel import (
            build_epoch_fn_ring,
            build_epoch_fn_scan,
        )

        D, B = 3, 32

        def loglike(theta):
            return -jnp.sum((theta - 0.5) ** 2)

        calc = make_batched_calculator(
            prior_fn=lambda c: c, loglike_fn=loglike, n_dims=D, n_derived=1
        )
        cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, **cfg_kwargs)
        ring = jax.jit(build_epoch_fn_ring(calc, cfg))
        scan = jax.jit(build_epoch_fn_scan(calc, cfg))

        key = jax.random.PRNGKey(key_seed)
        seeds = jnp.full((B, D), 0.5).at[3].set(0.42)
        bounds = jnp.full((B,), -0.09)
        chol = jnp.broadcast_to(0.7 * jnp.eye(D), (B, D, D))
        valid = jnp.ones((B,), bool).at[5].set(False)

        a = np.asarray(ring(key, seeds, bounds, chol, valid))
        b = np.asarray(scan(key, seeds, bounds, chol, valid))
        assert not a[:, -1].any(), "ring must not overflow here"
        # the tail column is the ring's overflow flag, the scan's loop trips
        assert np.array_equal(a[:, :-1], b[:, :-1])
        assert (b[:, -1] == b[0, -1]).all() and b[0, -1] >= cfg.total_repeats

    def test_multigrade(self):
        self._compare(dict(grade_dims=(2, 1), num_repeats=(6, 3)))

    def test_single_grade_odd_repeats(self):
        self._compare(dict(grade_dims=(3,), num_repeats=(11,)))

    def test_overflow_flag(self):
        """With a starved ring the engine must flag overflow, and the mesh
        runner must transparently fall back to the scan engine."""
        from polychordlite_tpu.ops.slice_kernel import build_epoch_fn_ring
        from polychordlite_tpu.parallel.mesh import make_epoch_runner

        D, B = 2, 16

        def loglike(theta):
            return -jnp.sum((theta - 0.5) ** 2)

        calc = make_batched_calculator(
            prior_fn=lambda c: c, loglike_fn=loglike, n_dims=D, n_derived=1
        )
        cfg = EpochConfig(
            n_dims=D,
            n_phi=calc.n_phi,
            grade_dims=(D,),
            num_repeats=(8,),
            ring_factor=1,  # ~8 slots for ~40+ iterations -> guaranteed overflow
        )
        ring = jax.jit(build_epoch_fn_ring(calc, cfg))
        key = jax.random.PRNGKey(3)
        seeds = jnp.full((B, D), 0.5)
        bounds = jnp.full((B,), -0.04)
        chol = jnp.broadcast_to(jnp.eye(D), (B, D, D))
        packed = np.asarray(ring(key, seeds, bounds, chol, jnp.ones((B,), bool)))
        assert packed[:, -1].all()

        # the runner falls back to scan and returns valid babies
        run, Bp = make_epoch_runner(calc, cfg, B, single_device=True)
        cube, theta, phi, logL, nlike = run(key, seeds, bounds, chol)
        assert np.all(logL >= -0.04 - 1e-5)


class TestHardWall:
    def test_logzero_region_is_excluded(self):
        """Points with logL <= logzero act as hard walls
        (chordal_sampling.f90:223,232,253)."""
        D, R, B = 2, 8, 64

        def loglike(theta):
            # forbidden half-plane theta_0 > 0.7
            return jnp.where(theta[0] > 0.7, LOG_ZERO, -jnp.sum((theta - 0.5) ** 2))

        epoch, _ = _make_epoch(D, R, loglike, n_phi=1)
        key = jax.random.PRNGKey(3)
        seeds = jnp.full((B, D), 0.5)
        bounds = jnp.full((B,), -0.2**2 * 10)  # generous bound
        chol = jnp.broadcast_to(jnp.eye(D), (B, D, D))
        out = epoch(key, seeds, bounds, chol, jnp.ones((B,), bool))
        cube = np.asarray(out[0])
        logL = np.asarray(out[3])
        ok = logL > LOG_ZERO
        assert ok.any()
        assert np.all(cube[..., 0][ok] <= 0.7 + 1e-6)
