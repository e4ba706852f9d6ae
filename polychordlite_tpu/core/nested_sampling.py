"""The nested-sampling main loop.

Accelerator re-architecture of ``src/polychord/nested_sampling.F90``: instead
of an MPI administrator/worker farm, each *epoch* generates a nursery of B
independent slice chains in one jitted device call (sharded over the chain
axis on a multi-chip mesh); the host administrator consumes the nursery in
vectorised chunks with the exact reference bookkeeping — a direct
generalisation of the reference's synchronous mode
(nested_sampling.F90:262-287) with B >> nprocs.  Epoch k+1 is dispatched to
the device before epoch k is consumed, so device compute overlaps host
bookkeeping (the reference's async administrator/worker overlap, :288-313).

Correctness of batched consumption: every baby was generated uniformly within
the iso-likelihood contour current at its epoch start; conditioning on its
likelihood exceeding the *risen* contour at insertion time leaves it uniform
within the new contour (the same argument that licenses the reference's
asynchronous mode, :288-313).  Cluster reorganisations bump ``rti.epoch``;
instead of discarding the rest of the nursery (the MPI administrator_epoch
mechanism, :341,357,364), the remaining babies are re-assigned to clusters by
the same Voronoi rule ``add_cluster`` applies to in-flight phantoms
(run_time_info.f90:444-453), so no generated work is thrown away."""

from __future__ import annotations

import copy
import math
import sys
import time
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.evaluate import make_batched_calculator
from ..ops.logspace import logsumexp, logsumexp_small
from ..ops.slice_kernel import EpochConfig, build_epoch_fn
from ..settings import PolyChordSettings
from ..utils import io as io_mod
from ..utils import resume as resume_mod
from ..utils.metrics import RunMetrics
from . import rti as rti_mod
from .clustering import do_clustering
from .generate import (
    assign_num_repeats,
    generate_live_points,
    generate_seeds,
    time_speeds,
)
from .rti import (
    RunTimeInfo,
    append_phantoms_batch,
    calculate_logZ_estimate,
    calculate_covmats,
    delete_cluster,
    delete_outermost_point,
    find_min_loglikelihoods,
    identify_clusters_batch,
    live_logZ,
    replace_point,
    try_replace_live,
    update_posteriors,
)

__version__ = "0.1.0"


def default_prior(cube):
    return cube


def default_dumper(live, dead, logweights, logZ, logZerr):
    pass


def resolve_engine(engine: str, graded: bool = False) -> str:
    """Resolve ``engine="auto"`` to the concrete engine.

    One hot-path story (the reference has exactly one,
    nested_sampling.F90:259): ``"auto"`` is the scan engine on every
    backend and for every likelihood.  Decomposed fast/slow likelihoods
    (models/graded.py) always use the scan engine — it is the one carrying
    the slow-part cache.  A name that is not an engine raises
    ``ValueError``; nothing falls back to another engine.
    """
    from ..ops.slice_kernel import ENGINES

    if engine != "auto" and engine not in ENGINES:
        raise ValueError(
            f"unknown slice engine {engine!r}; choose 'auto' or one of "
            f"{ENGINES}"
        )
    if graded:
        if engine not in ("auto", "scan"):
            import warnings

            warnings.warn(
                f"engine={engine!r} is ignored for decomposed fast/slow "
                f"(GradedLikelihood) runs: only the scan engine carries "
                f"the slow-part cache. Running engine='scan'.",
                stacklevel=2,
            )
        return "scan"
    return "scan" if engine == "auto" else engine


def more_samples_needed(s: PolyChordSettings, rti: RunTimeInfo) -> bool:
    """Termination rule (nested_sampling.F90:514-543)."""
    if s.max_ndead == 0:
        return False
    if s.max_ndead > 0 and rti.ndead >= s.max_ndead:
        return False
    if (
        s.precision_criterion > 0
        and live_logZ(rti) < math.log(s.precision_criterion) + rti.logZ
    ):
        return False
    return True


def _dump(dumper, s: PolyChordSettings, rti: RunTimeInfo) -> None:
    """Deliver live/dead/weights/evidence to the user callback
    (nested_sampling.F90:546-590; Python array convention: rows = points,
    columns = [physical, derived, birth, logL])."""
    dead = rti.dead_array()
    cols_dead = np.concatenate(
        [dead[:, s.pd], dead[:, [s.b0]], dead[:, [s.l0]]], axis=1
    )
    logw = np.asarray(rti.logweights) + dead[:, s.l0]
    if logw.size:
        logw = logw - logsumexp(np, logw)
    live = rti.all_live()
    cols_live = np.concatenate(
        [live[:, s.pd], live[:, [s.b0]], live[:, [s.l0]]], axis=1
    )
    logZ, varlogZ, *_ = calculate_logZ_estimate(rti)
    dumper(cols_live, cols_dead, logw, logZ, math.sqrt(abs(varlogZ)))


def _write_products(s: PolyChordSettings, rti: RunTimeInfo, nlikesum, rng, key):
    # file output is owned by process 0 only, as in the reference where all
    # writes happen on the MPI administrator (nested_sampling.F90:329-334)
    from ..parallel.distributed import is_root

    if not is_root():
        return
    if s.write_resume:
        resume_mod.write_resume_file(s, rti, rng, key)
    if s.write_live:
        io_mod.write_phys_live_points(s, rti)
    if s.write_dead:
        io_mod.write_dead_points(s, rti)
    if s.write_stats:
        io_mod.write_stats_file(s, rti, nlikesum)
    if s.equals or s.posteriors:
        io_mod.write_posterior_files(s, rti)


def _feedback(s: PolyChordSettings, level: int, msg: str) -> None:
    if s.feedback >= level:
        print(msg, flush=True)


def nested_sampling(
    loglikelihood: Callable,
    prior: Callable,
    dumper: Callable,
    settings: PolyChordSettings,
):
    """Run the sampler.  Returns a dict with logZ, logZerr, ndead, nlike and
    the final state (the [logZ, varlogZ, ndead, nlike] output of
    NestedSampling, nested_sampling.F90:394-402, plus extras)."""
    s = settings.finalise()
    t_start = time.time()

    # --- precision mode (ops/precision.py) ---------------------------------
    from contextlib import ExitStack

    from ..ops.precision import F32_SAFE_LOGL, real_dtype, set_real_dtype

    dtype_before = real_dtype()
    precision_ctx = ExitStack()
    if getattr(s, "precision", "single") == "highest":
        # THREAD-LOCAL x64 scope: a concurrent default-precision run on
        # another thread of this process is unaffected
        precision_ctx.enter_context(jax.enable_x64(True))
        set_real_dtype(jnp.float64)
    else:
        set_real_dtype(jnp.float32)

    # --- RNG: one host generator + one device key, both from the seed ------
    seed = s.seed if s.seed >= 0 else int(time.time_ns() % (2**31))
    if jax.process_count() > 1:
        # every process must administer identically: adopt root's clock seed
        from ..parallel.distributed import broadcast_from_root

        seed = int(broadcast_from_root(np.int64(seed)))
    rng = np.random.default_rng(seed)
    key = jax.random.PRNGKey(seed)

    from ..utils import feedback as fb

    # --- likelihood/prior evaluation path ----------------------------------
    calc = make_batched_calculator(
        prior, loglikelihood, s.nDims, s.nDerived, s.logzero
    )
    # Host-callback likelihoods run their epochs on the host CPU device: the
    # likelihood is host code, so an accelerator-resident slice loop would
    # make a device->host->device round trip on every loop trip.
    epoch_device = (
        jax.local_devices(backend="cpu")[0] if calc.uses_callback
        else jax.devices()[0]
    )
    fb.write_opening_statement(s, __version__, epoch_device)
    if (
        getattr(calc, "graded", False)
        and len(s.grade_dims) > 1
        and int(s.grade_dims[0]) != int(calc.n_slow)
    ):
        # fast-grade chords must only move fast parameters: a mismatch means
        # a fast probe could perturb a slow coordinate while the cached slow
        # intermediate stays stale, silently corrupting logL and logZ
        raise ValueError(
            f"GradedLikelihood with n_slow={calc.n_slow} requires "
            f"grade_dims[0] == n_slow, got grade_dims={list(s.grade_dims)}"
        )
    device_ctx = None
    if calc.uses_callback:
        device_ctx = jax.default_device(epoch_device)
        device_ctx.__enter__()

    n_grades = len(s.grade_dims) if s.grade_dims else 1

    try:
        # --- resume or generate --------------------------------------------
        from ..parallel.distributed import is_root

        io_mod.check_directories(s)
        if is_root():
            io_mod.write_properties_file(s)  # anesthetic compat marker
        resumed = False
        want_resume = s.read_resume and resume_mod.resume_file_exists(s)
        if jax.process_count() > 1:
            # resume files are written by process 0 only: every process must
            # follow ROOT's resume decision or the redundantly-deterministic
            # administrations desynchronise and the SPMD epoch dispatch hangs
            # (reference: rank 0 reads, state is implicitly shared because
            # every rank re-runs the same deterministic stream).  The
            # agreement is allgathered so EVERY process (including the ones
            # that do see the file) raises the same error — raising on a
            # subset turns a config error into a distributed deadlock.
            from ..parallel.distributed import all_any_flags

            all_resume, any_resume = all_any_flags(want_resume)
            if any_resume and not all_resume:
                raise RuntimeError(
                    "the resume file is visible on some processes but not "
                    "all: multi-host runs need base_dir on a filesystem "
                    "shared by all processes (or read_resume=False)"
                )
            want_resume = all_resume
        if want_resume:
            rti, rng_state, key_saved = resume_mod.read_resume_file(s, n_grades)
            if rng_state is not None:  # legacy-text resumes carry no RNG state
                rng.bit_generator.state = rng_state
                key = jnp.asarray(key_saved)
            resumed = True
            _feedback(s, 1, "Resuming from previous run")
        elif s.cube_samples is not None:
            rti = resume_mod.rti_from_cube_samples(s, s.cube_samples, calc, n_grades)
            speeds = time_speeds(calc, s, key)
            assign_num_repeats(s, rti, speeds)
            _feedback(s, 1, f"Starting from {rti.total_nlive()} cube samples")
        else:
            _feedback(s, 1, "Generating initial live points")
            rti, ndiscarded, sec_per_eval = generate_live_points(
                calc, s, rng, jax.random.fold_in(key, 0)
            )
            if s.write_prior and is_root():
                io_mod.write_prior_file(s, rti)
                io_mod.write_prior_info(s, s.resolved_nprior(), ndiscarded)
            speeds = time_speeds(calc, s, key)
            speeds[0] = max(sec_per_eval, 1e-12)
            assign_num_repeats(s, rti, speeds)
        rti._rng = rng

        if rti.num_repeats is None:
            speeds = time_speeds(calc, s, key)
            assign_num_repeats(s, rti, speeds)

        # trim nprior down to nlive, accumulating the evidence of the
        # deleted shells (nested_sampling.F90:200-204)
        if not resumed:
            while rti.total_nlive() > s.nlive:
                delete_outermost_point(rti)
            if s.write_resume and is_root():
                resume_mod.write_resume_file(s, rti, rng, key)

        num_repeats = tuple(int(x) for x in rti.num_repeats)
        _feedback(s, 1, f"num_repeats per grade: {list(num_repeats)}")

        # --- build the device epoch function -------------------------------
        engine = resolve_engine(s.engine, getattr(calc, "graded", False))
        if real_dtype() == jnp.float32:
            maxabs = float(np.abs(rti.all_live()[:, s.l0]).max(initial=0.0))
            if maxabs > F32_SAFE_LOGL:
                import warnings

                warnings.warn(
                    f"|logL| reaches {maxabs:.3g}: the f32 contour test "
                    f"loses resolution beyond ~{F32_SAFE_LOGL:.0g} "
                    f"(ulp(1e7)=1). Use precision='highest' (f64 scan "
                    f"engine).",
                    stacklevel=2,
                )
        cfg = EpochConfig(
            n_dims=s.nDims,
            n_phi=max(s.nDerived, 1),
            grade_dims=tuple(s.grade_dims),
            num_repeats=num_repeats,
            logzero=s.logzero,
            engine=engine,
        )
        R = cfg.total_repeats
        from ..parallel.mesh import make_epoch_runner

        if not s.synchronous:
            # dispatch-ahead staleness carries a small positive logZ bias
            # at ANY batch width (64-seed calibration on the current
            # sampler: mean pull +0.25 to +0.32, logZ bias +0.04 to
            # +0.06; width-independent — see
            # benchmarks/calibration_study.json).  Synchronous mode
            # measures unbiased at the same widths.
            import warnings

            warnings.warn(
                "synchronous=False (dispatch-ahead) overlaps device and "
                "host work but biases logZ high by ~+0.05 (~0.3 sigma of "
                "a typical run's error bar; "
                "benchmarks/calibration_study.json, 64 seeds/config). "
                "Use synchronous=True (the default) when evidence "
                "accuracy matters more than throughput.",
                stacklevel=2,
            )
        run_epoch, B = make_epoch_runner(
            calc, cfg, s.resolved_batch_size(),
            single_device=calc.uses_callback,
            n_devices=s.mesh_shape,
        )
        n_dev = (
            1 if calc.uses_callback
            else (s.mesh_shape or len(jax.devices()))
        )
        _feedback(
            s, 1,
            f"chain batch {B} over {n_dev} device(s), engine "
            f"{run_epoch.engine_used()}",
        )

        from ..parallel.distributed import is_root as _is_root

        metrics = RunMetrics(
            io_mod.root_path(s) + ".metrics.jsonl"
            if s.write_stats and _is_root()
            else None,
            resume=resumed,
        )
        nlikesum = np.zeros(n_grades, dtype=np.int64)
        # per-e-fold file products are formatted+written by a background
        # thread over a state snapshot (utils/writebehind.py) — measured as
        # the administrator's largest host phase when synchronous
        from ..utils.writebehind import WriteBehindWriter

        any_writes = _is_root() and (
            s.write_resume or s.write_live or s.write_dead
            or s.write_stats or s.equals or s.posteriors
        )
        writer = WriteBehindWriter() if any_writes else None
        failures = 0
        nfail = s.resolved_nfail()
        # Resumes continue the device RNG stream where the saved run left
        # off (the reference restores and *continues* the generator state,
        # read_write.F90:384-476): epoch_idx is part of the checkpoint, so
        # post-resume epochs fold fresh indices into the epoch key instead
        # of replaying the streams of epochs 0..k.
        epoch_idx = int(getattr(rti, "epoch_idx", 0))
        t_assemble = 0.0  # nursery record assembly (epoch_timers)

        _feedback(s, 1, "Started sampling")

        # --- main loop ------------------------------------------------------
        # Async overlap (nested_sampling.F90:288-313 license): epoch k+1 is
        # dispatched to the device BEFORE the host consumes epoch k's nursery,
        # so device compute and host bookkeeping run concurrently.  Babies are
        # then up to two nurseries stale; acceptance against the current
        # contour (and Voronoi re-validation after cluster reorganisations)
        # keeps the sampling exact for the same reason the reference's async
        # mode is.
        running = more_samples_needed(s, rti)

        def _dispatch():
            nonlocal epoch_idx
            with metrics.phase("seed_gen"):
                seeds, cluster_ids = generate_seeds(rti, B, rng)
            bound = np.asarray(rti.logLp[cluster_ids], dtype=np.float64).copy()
            chol = rti.cholesky[cluster_ids]
            epoch_key = jax.random.fold_in(key, 100_000 + epoch_idx)
            epoch_idx += 1
            rti.epoch_idx = epoch_idx  # checkpointed: resume continues the stream
            handle = run_epoch.dispatch(epoch_key, seeds[:, s.h], bound, chol)
            return handle, bound, np.asarray(cluster_ids), rti.epoch

        # --- chained epochs ("turbo", ops/chained_epoch.py) ---------------
        # K epochs + the live-set consume loop in ONE device dispatch: fewer
        # host<->device round trips for synchronous runs.  The host replays
        # every decision through the ordinary bookkeeping and verifies its
        # live set against the device's final state.
        from collections import deque

        nursery_queue = deque()
        turbo_K = int(getattr(s, "chain_epochs", -1))
        if turbo_K < 0:
            turbo_K = 8 if (
                s.synchronous
                and not calc.uses_callback
                and not getattr(calc, "graded", False)
                and n_dev == 1
                and engine != "ring"
                and getattr(calc, "theta_batch_host", None) is not None
            ) else 0
        # cooldown: after a reorganisation discards a chain, fall back to
        # per-epoch dispatch for a few e-folds — actively-fragmenting runs
        # (eggbox/shells) otherwise thrash chains that splits keep
        # discarding, paying K epochs of device work per accepted nursery
        turbo = {"enabled": turbo_K > 1, "K": turbo_K, "verify": None,
                 "cooldown": 0, "epochs": 0}

        def _turbo_ok():
            return (
                turbo["enabled"]
                and turbo["cooldown"] == 0
                and s.synchronous
                and rti.ncluster == 1
                and not s.nlives
                and rti.total_nlive() == s.nlive
            )

        def _dispatch_any():
            nonlocal epoch_idx
            if _turbo_ok():
                K = turbo["K"]
                if s.max_ndead > 0:  # do not chain far past the cap
                    remaining = max(1, s.max_ndead - rti.ndead)
                    K = max(1, min(K, -(-remaining // B)))
                live = rti.live[0]
                epoch_key = jax.random.fold_in(key, 100_000 + epoch_idx)
                epoch_idx += 1
                rti.epoch_idx = epoch_idx
                h = run_epoch.dispatch_chain(
                    epoch_key, live[:, s.h], live[:, s.l0],
                    rti.cholesky[0], K,
                )
                turbo["epochs"] += K
                return ("chain", h, rti.epoch)
            return ("single", _dispatch())

        pending = _dispatch_any() if running else None
        while running and failures <= nfail and rti.ncluster > 0:
            if not nursery_queue:
                if pending[0] == "single":
                    handle, bound, cluster_ids, epoch_at_dispatch = pending[1]
                    with metrics.device_epoch():
                        outs = run_epoch.collect(handle)
                    nursery_queue.append(
                        (*outs, bound, cluster_ids, epoch_at_dispatch)
                    )
                    turbo["verify"] = None
                else:
                    _, handle, epoch_at = pending
                    with metrics.device_epoch():
                        nurseries, final_ll = run_epoch.collect_chain(handle)
                    zero_ids = np.zeros(B, dtype=int)
                    for cube_k, th_k, phi_k, logL_k, nl_k, b0 in nurseries:
                        nursery_queue.append(
                            (cube_k, th_k, phi_k, logL_k, nl_k,
                             np.full(B, b0), zero_ids, epoch_at)
                        )
                    turbo["verify"] = final_ll
                if not s.synchronous:
                    # async overlap (nested_sampling.F90:288-313): enqueue
                    # the next nursery before consuming this one — device
                    # compute hides behind host bookkeeping, babies up to 2
                    # nurseries stale (turbo is gated to synchronous mode)
                    pending = _dispatch_any()
            (b_cube, b_theta, b_phi, b_logL, nlike, bound, cluster_ids,
             epoch_at_dispatch) = nursery_queue.popleft()
            nlike = nlike.sum(axis=0)
            rti.nlike += nlike
            nlikesum += nlike

            # assemble (B, R, nTotal) baby records; birth contour = the
            # bound the chain was generated at (nested_sampling.F90:260)
            _t0 = time.time()
            babies = np.zeros((B, R, s.nTotal))
            babies[:, :, s.h] = b_cube
            babies[:, :, s.p] = b_theta
            if s.nDerived:
                babies[:, :, s.d] = b_phi[:, :, : s.nDerived]
            babies[:, :, s.b0] = bound[:, None]
            babies[:, :, s.l0] = b_logL
            t_assemble += time.time() - _t0

            # --- consume the nursery in vectorised chunks -------------------
            # Cluster reorganisations no longer discard the remaining nursery
            # (round-1 behaviour): stale seed-cluster ids are re-assigned by
            # the same Voronoi rule add_cluster applies to phantoms
            # (run_time_info.f90:444-453).
            ids = cluster_ids.copy()
            if rti.epoch != epoch_at_dispatch:
                ids = identify_clusters_batch(rti, babies[:, -1])
            chunk = max(8, min(64, s.nlive // 8))
            b0 = 0
            ph_done = 0  # phantom-insertion high-water mark: a chunk that
            # breaks early on a cluster reorganisation restarts at b0 = b,
            # but its phantoms were already inserted up to the old b1 —
            # re-inserting them would duplicate posterior samples and skew
            # covmats (the reorganisation re-Voronois the already-inserted
            # copies, so they survive).
            while (
                b0 < B and running and failures <= nfail and rti.ncluster > 0
            ):
                b1 = min(b0 + chunk, B)
                epoch0 = rti.epoch
                # phantom candidates of the chunk, one batched insert
                if R > 1 and b1 > ph_done:
                    lo = max(b0, ph_done)
                    append_phantoms_batch(
                        rti,
                        babies[lo:b1, :-1].reshape(-1, s.nTotal),
                        np.repeat(ids[lo:b1], R - 1),
                    )
                    ph_done = b1
                # live candidates: Voronoi membership batched per sub-block.
                # The reference evaluates identify_cluster at insertion time
                # against the CURRENT live set (run_time_info.f90:744-753);
                # here membership is recomputed every VORONOI_SUB
                # replacements, so a baby's cell is stale by at most
                # VORONOI_SUB deletions (<= ~3% of nlive) instead of a full
                # chunk (~64).  Affects cluster assignment only, never the
                # global evidence.
                VORONOI_SUB = 16
                lpts = babies[b0:b1, -1]
                assign = identify_clusters_batch(rti, lpts)
                _nested = ("posteriors", "file_writes", "dumper", "clustering")
                t_loop0 = time.time()
                _n0 = sum(metrics._phase_tot.get(k, 0.0) for k in _nested)
                b = b0
                while b < b1:
                    if rti.epoch != epoch0:
                        break  # reorganisation: re-validate remaining babies
                    i = b - b0
                    if i and i % VORONOI_SUB == 0:
                        assign[i:] = identify_clusters_batch(rti, lpts[i:])
                    res = try_replace_live(
                        rti, lpts[i], int(ids[b]), bool(assign[i] == ids[b])
                    )
                    b += 1
                    if res is True:
                        failures = 0
                    else:
                        failures += 1
                        if failures > nfail:
                            break

                    lse_logXp = logsumexp_small(rti.logXp)
                    update = (
                        lse_logXp
                        <= rti.logX_last_update + math.log(s.compression_factor)
                    )
                    if update:
                        if turbo["cooldown"] > 0:
                            turbo["cooldown"] -= 1
                        rti.logX_last_update = lse_logXp
                        with metrics.phase("posteriors"):
                            update_posteriors(rti)
                        with metrics.phase("file_writes"):
                            if writer is not None:
                                snap_rti = rti.snapshot()
                                snap_rng = copy.deepcopy(rng)
                                snap_nl = nlikesum.copy()
                                writer.submit(
                                    lambda r=snap_rti, g=snap_rng, n=snap_nl:
                                    _write_products(s, r, n, g, key)
                                )
                        with metrics.phase("dumper"):
                            _dump(dumper, s, rti)

                    delete_cluster(rti)
                    if rti.ncluster == 0:
                        break

                    if update:
                        logZ, varlogZ, *_ = calculate_logZ_estimate(rti)
                        metrics.record(
                            ndead=rti.ndead,
                            nlive=rti.total_nlive(),
                            ncluster=rti.ncluster,
                            logZ=logZ,
                            varlogZ=varlogZ,
                            nlike=int(rti.nlike.sum()),
                            engine=run_epoch.engine_used(),
                        )
                        frac = math.exp(
                            min(live_logZ(rti) - rti.logZ, 700.0)
                        ) if rti.logZ > s.logzero else float("inf")
                        fb.write_intermediate_results(
                            s, rti, nlikesum, logZ, varlogZ, frac
                        )
                        nlikesum[:] = 0
                        with metrics.phase("clustering"):
                            if s.do_clustering:
                                if s.sub_clustering_dimensions:
                                    do_clustering(
                                        rti, s.sub_clustering_dimensions
                                    )
                                do_clustering(rti)
                            calculate_covmats(rti)

                    running = more_samples_needed(s, rti)
                    if not running:
                        break
                # pure insertion cost: exclude the nested e-fold phases
                _n1 = sum(metrics._phase_tot.get(k, 0.0) for k in _nested)
                metrics._phase_tot["baby_loop"] = (
                    metrics._phase_tot.get("baby_loop", 0.0)
                    + (time.time() - t_loop0)
                    - (_n1 - _n0)
                )
                if rti.epoch != epoch0 and rti.ncluster > 0 and b < B:
                    ids[b:] = identify_clusters_batch(rti, babies[b:, -1])
                b0 = b

            # reorganisation during this nursery: queued chain nurseries
            # came from a one-cluster device state — discard them (bounded
            # waste, <= K-1 epochs; the reference's administrator_epoch
            # discards in-flight babies the same way)
            if nursery_queue and rti.epoch != epoch_at_dispatch:
                nursery_queue.clear()
                turbo["verify"] = None
                turbo["cooldown"] = 4  # e-folds of per-epoch dispatch

            if not nursery_queue and turbo["verify"] is not None:
                # chain fully replayed: the host live set must match the
                # device's final state exactly (multiset of logL)
                if (
                    rti.epoch == epoch_at_dispatch
                    and rti.ncluster == 1
                    and running
                    and failures <= nfail
                    and rti.total_nlive() == len(turbo["verify"])
                ):
                    host_ll = np.sort(
                        rti.live[0][:, s.l0].astype(np.float32)
                    )
                    dev_ll = np.sort(
                        np.asarray(turbo["verify"], dtype=np.float32)
                    )
                    if not np.array_equal(host_ll, dev_ll):
                        import warnings

                        warnings.warn(
                            "chained-epoch replay diverged from the device "
                            "live state; disabling chained epochs for this "
                            "run",
                            stacklevel=2,
                        )
                        turbo["enabled"] = False
                turbo["verify"] = None

            if (
                s.synchronous and not nursery_queue
                and running and failures <= nfail and rti.ncluster > 0
            ):
                # synchronous mode (reference default, nested_sampling.F90:
                # 262-287): seeds drawn from the state as updated by this
                # nursery; exactly one nursery (or chain) in flight
                pending = _dispatch_any()

        if writer is not None:
            writer.flush()
        if s.write_resume and is_root():
            resume_mod.write_resume_file(s, rti, rng, key)

        # --- optional maximisation -----------------------------------------
        if s.maximise:
            from .maximiser import maximise

            maximise(calc, s, rti)

        # --- drain the remaining live points (nested_sampling.F90:381-384) -
        while rti.ncluster > 0:
            delete_outermost_point(rti)
            delete_cluster(rti)

        update_posteriors(rti)
        from ..parallel.distributed import is_root

        if is_root():
            if s.write_live:
                io_mod.write_phys_live_points(s, rti)
            if s.equals or s.posteriors:
                io_mod.write_posterior_files(s, rti)
            if s.write_dead:
                io_mod.write_dead_points(s, rti)
            if s.write_stats:
                io_mod.write_stats_file(s, rti, nlikesum)
        _dump(dumper, s, rti)

        logZ, varlogZ, *_ = calculate_logZ_estimate(rti)
        if failures > nfail:
            print(
                f"Warning, unable to proceed after {failures} failed spawn events",
                flush=True,
            )
        if s.feedback >= 0:
            fb.write_final_results(
                logZ, varlogZ, rti.ndead, rti.nlike.tolist(),
                time.time() - t_start, s.feedback,
            )

        epoch_timers = {
            **{k: round(v, 3) for k, v in run_epoch.timers.items()},
            "assemble": round(t_assemble, 3),
        }
        # where the epochs ran, and how many ran inside chained dispatches
        placement = {
            "epoch_platform": epoch_device.platform,
            "epoch_devices": n_dev,
            "chained_epochs": turbo["epochs"],
        }
        metrics.record(
            ndead=rti.ndead,
            nlive=0,
            ncluster=rti.ncluster,
            logZ=logZ,
            varlogZ=varlogZ,
            nlike=int(rti.nlike.sum()),
            engine=run_epoch.engine_used(),
            extra={"epoch_timers": epoch_timers, **placement},
        )
        return {
            "logZ": float(logZ),
            "logZerr": float(math.sqrt(abs(varlogZ))),
            "ndead": int(rti.ndead),
            "nlike": int(rti.nlike[0]),
            "nlike_per_grade": rti.nlike.copy(),
            "metrics": {
                **metrics.summary(ndead=rti.ndead, nlike=int(rti.nlike.sum())),
                "engine_used": run_epoch.engine_used(),
                "epoch_timers": epoch_timers,
                **placement,
            },
            "rti": rti,
        }
    finally:
        try:
            if "writer" in locals() and writer is not None:
                writer.close()
        except Exception:
            pass
        if device_ctx is not None:
            device_ctx.__exit__(None, None, None)
        # restore this thread's precision state for subsequent runs
        set_real_dtype(dtype_before)
        precision_ctx.close()
