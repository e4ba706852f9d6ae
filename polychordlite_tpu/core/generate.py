"""Initial live-point generation, seed selection and speed-grade timing.

Batched re-expression of ``src/polychord/generate.F90``: the prior-generation MPI
farm (:186-261) becomes batched device evaluation of uniform hypercube draws;
``GenerateSeed`` (:19-55) picks clusters in proportion to volume on the host;
``time_speeds`` (:330-455) times per-grade likelihood cost with real device
timings to apportion per-grade repeat counts.
"""

from __future__ import annotations

import time
from typing import Callable, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..core.rti import RunTimeInfo, find_min_loglikelihoods
from ..settings import PolyChordSettings


def generate_live_points(
    calc: Callable,
    s: PolyChordSettings,
    rng: np.random.Generator,
    key,
    feedback_cb=None,
) -> Tuple[RunTimeInfo, int, float]:
    """Sample ``nprior`` points uniform in the hypercube, rejecting
    ``logL <= logzero`` (generate.F90:61-326).  Returns
    (rti, ndiscarded, seconds_per_eval)."""
    nprior = s.resolved_nprior()
    rti = RunTimeInfo(s, len(s.grade_dims))

    batch = max(64, min(4 * nprior, 4096))

    # One packed device->host transfer per round:
    # [cube(D), theta(D), phi(n_phi), logL] per row.
    @jax.jit
    def gen_round(sub):
        cube = jax.random.uniform(sub, (batch, s.nDims), dtype=jnp.float32)
        theta, phi, logL = calc(cube)
        return jnp.concatenate([cube, theta, phi, logL[:, None]], axis=1)

    accepted = []
    ndiscarded = 0
    nlike = 0
    total_time = 0.0
    round_idx = 0
    n_phi = max(s.nDerived, 1)
    while sum(a.shape[0] for a in accepted) < nprior and round_idx < 10000:
        sub = jax.random.fold_in(key, round_idx)
        round_idx += 1
        t0 = time.perf_counter()
        packed = np.asarray(gen_round(sub), dtype=np.float64)
        t1 = time.perf_counter()
        total_time += t1 - t0
        cube = packed[:, : s.nDims]
        theta = packed[:, s.nDims : 2 * s.nDims]
        phi = packed[:, 2 * s.nDims : 2 * s.nDims + n_phi]
        logL = packed[:, -1]
        ok = logL > s.logzero
        ndiscarded += batch
        nlike += int(ok.sum())
        pts = np.zeros((int(ok.sum()), s.nTotal))
        pts[:, s.h] = cube[ok]
        pts[:, s.p] = theta[ok]
        if s.nDerived:
            pts[:, s.d] = phi[ok][:, : s.nDerived]
        pts[:, s.b0] = s.logzero
        pts[:, s.l0] = logL[ok]
        accepted.append(pts)
        if feedback_cb is not None:
            feedback_cb(min(sum(a.shape[0] for a in accepted), nprior), nprior)

    pts = np.concatenate(accepted, axis=0)[:nprior]
    rti.live[0] = pts
    rti.nlike[0] = nlike
    find_min_loglikelihoods(rti)
    sec_per_eval = total_time / max(ndiscarded, 1)
    return rti, ndiscarded, sec_per_eval


def assign_num_repeats(
    s: PolyChordSettings,
    rti: RunTimeInfo,
    speeds: np.ndarray,
) -> None:
    """Per-grade repeat counts (generate.F90:303-316): grade 1 gets
    ``num_repeats``; faster grades get counts scaled by grade_frac and the
    measured speed ratio.  Also sets the posterior thinning factor."""
    from ..parallel.distributed import broadcast_from_root

    # wall-clock timings differ per process; root's decide (MPI_BCAST analogue)
    speeds = broadcast_from_root(np.asarray(speeds, dtype=float))
    gf = np.asarray(s.grade_frac, dtype=float)
    n_grades = len(s.grade_dims)
    num_repeats = np.empty(n_grades, dtype=int)
    if (gf <= 1).any():
        num_repeats[0] = s.num_repeats
        if n_grades > 1:
            num_repeats[1:] = np.rint(
                gf[1:] / gf[0] * num_repeats[0] * speeds[0] / speeds[1:]
            ).astype(int)
    else:
        num_repeats[:] = gf.astype(int)
    num_repeats = np.maximum(num_repeats, 1)
    rti.num_repeats = num_repeats

    if s.boost_posterior < 0:
        rti.thin_posterior = 1.0
    else:
        rti.thin_posterior = float(s.boost_posterior) / float(num_repeats.sum())


def time_speeds(calc, s: PolyChordSettings, key) -> np.ndarray:
    """Measure per-grade likelihood cost (generate.F90:330-455) with batched
    device timing: grade g's 'fast' evaluation varies only dimensions from
    grade g onward.  For monolithic JAX likelihoods all grades cost the same
    (no partial-recomputation structure), reproducing grade_frac-proportional
    repeats; a likelihood with genuine fast/slow structure shows real ratios."""
    n_grades = len(s.grade_dims)
    speeds = np.ones(n_grades)
    if n_grades == 1 or not (np.asarray(s.grade_frac) <= 1).any():
        return speeds
    B = 256
    base = jax.random.uniform(jax.random.fold_in(key, 991), (B, s.nDims))
    # warm up / compile
    jax.block_until_ready(calc(base))
    if getattr(calc, "graded", False) and n_grades == 2:
        # decomposed likelihood (models/graded.py): time the two REAL code
        # paths the engine will run — full (slow+fast) evaluation vs the
        # fast completion on a cached slow intermediate — instead of
        # perturb-and-recompute (which measures 1.0 by construction for a
        # monolithic callable)
        aux = jax.block_until_ready(calc.slow_aux_batch(base))
        jax.block_until_ready(calc.fast_point_batch(aux, base))
        reps = 3
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(calc(base))
        t_full = (time.perf_counter() - t0) / (reps * B)
        t0 = time.perf_counter()
        for _ in range(reps):
            jax.block_until_ready(calc.fast_point_batch(aux, base))
        t_fast = (time.perf_counter() - t0) / (reps * B)
        speeds[0] = max(t_full, 1e-12)
        speeds[1] = max(t_fast, 1e-12)
        return speeds
    for g in range(n_grades):
        start = int(sum(s.grade_dims[:g]))
        reps = 3
        t0 = time.perf_counter()
        for r in range(reps):
            pert = base.at[:, start:].set(
                jax.random.uniform(
                    jax.random.fold_in(key, 1000 + 17 * g + r),
                    (B, s.nDims - start),
                )
            )
            jax.block_until_ready(calc(pert))
        speeds[g] = (time.perf_counter() - t0) / (reps * B)
    return speeds


def generate_seeds(
    rti: RunTimeInfo, n: int, rng: np.random.Generator
) -> Tuple[np.ndarray, np.ndarray]:
    """Draw ``n`` slice-chain seeds: cluster chosen with probability
    proportional to its volume estimate, then a uniform live point within it
    (GenerateSeed, generate.F90:19-55).  Returns (seed_points (n, nTotal),
    cluster_ids (n,))."""
    s = rti.settings
    logp = rti.logXp - rti.logXp.max()
    probs = np.exp(logp)
    probs /= probs.sum()
    clusters = rng.choice(rti.ncluster, size=n, p=probs)
    seeds = np.empty((n, s.nTotal))
    for b in range(n):
        c = int(clusters[b])
        nl = rti.live[c].shape[0]
        if nl == 0:  # degenerate: fall back to any non-empty cluster
            c = int(np.argmax(rti.nlive))
            clusters[b] = c
            nl = rti.live[c].shape[0]
        seeds[b] = rti.live[c][rng.integers(nl)]
    return seeds, clusters
