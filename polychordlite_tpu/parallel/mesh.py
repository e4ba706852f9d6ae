"""Device-mesh sharding of the chain batch.

The reference's MPI likelihood farm (``src/polychord/mpi_utils.F90``; SURVEY
§5.8) maps to a 1-D ``chains`` mesh axis: the nursery of B slice chains is
sharded across devices with ``jax.shard_map``; every lane is independent (the
per-lane RNG streams are keyed by *global* lane index), so the epoch issues
ZERO collectives and each device drains its own lanes' while-loop without
waiting on stragglers elsewhere.  The random streams do not depend on the
device count; on the CPU the results are bitwise identical for any device
count, while on GPUs XLA picks kernels per shard shape, which can change
the last bit of a rounding and, rarely, a slice decision.

The batch width B is rounded up to a multiple of 8 lanes per device.  Epoch
I/O crosses the host-device boundary as exactly one upload and one download
per epoch (packed buffers).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..ops.precision import real_dtype
from ..ops.slice_kernel import (
    EpochConfig,
    build_epoch_fn,
    build_epoch_fn_scan,
    epoch_overflowed,
    unpack_epoch,
)


# Cross-run jit caches: runs re-created with the SAME calc object (see
# make_batched_calculator's memoisation) reuse compiled engines and chains
# instead of paying a multi-second retrace+recompile per run() call.
_ENGINE_CACHE = {}
_CHAIN_CACHE = {}
_CACHE_MAX = 64


def _cache_put(cache, key, value):
    if len(cache) >= _CACHE_MAX:
        cache.pop(next(iter(cache)))
    cache[key] = value


def make_epoch_runner(
    calc: Callable,
    cfg: EpochConfig,
    batch_size: int,
    single_device: bool = False,
    devices=None,
    n_devices: Optional[int] = None,
) -> Tuple[Callable, int]:
    """Build ``run(key, seeds, bound, chol) -> (cube, theta, phi, logL,
    nlike)`` (numpy outputs) and the logical chain-batch width B."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[: max(1, int(n_devices))]
    n_dev = 1 if single_device else len(devices)
    axis = None if n_dev == 1 else "chains"
    B = -(-batch_size // (8 * n_dev)) * (8 * n_dev)
    D = cfg.n_dims

    def pack_inputs(seed_cube, bound, chol):
        """One upload buffer: per lane [cube(D), bound, cholesky.ravel(D*D)]."""
        return np.concatenate(
            [seed_cube, bound[:, None], chol.reshape(B, D * D)], axis=1
        ).astype(real_dtype())

    # Compact fetch: theta = prior(cube) is deterministic, so the theta
    # columns of every baby record are dropped ON DEVICE before the fetch
    # (~40-50 % of the nursery payload) and re-derived on the host CPU
    # by calc.theta_batch_host with identical cube-wall semantics.
    # Host-callback models keep the full fetch (their prior may not be
    # traceable, and they run CPU-side anyway).
    stride = 2 * D + cfg.n_phi + 1
    R_tot = cfg.total_repeats
    tail = len(cfg.grade_dims) + 1  # per-grade nlike + overflow flag
    compact = getattr(calc, "theta_batch_host", None) is not None

    def compile_engine(epoch_fn):
        def wrapped(key, packed_in):
            seed_cube = packed_in[:, :D]
            bound = packed_in[:, D]
            chol = packed_in[:, D + 1 :].reshape(-1, D, D)
            valid = jnp.ones((packed_in.shape[0],), bool)
            out = epoch_fn(key, seed_cube, bound, chol, valid)
            if compact:
                rec = out[:, : R_tot * stride].reshape(-1, R_tot, stride)
                rec = jnp.concatenate(
                    [rec[:, :, :D], rec[:, :, 2 * D :]], axis=2
                ).reshape(out.shape[0], R_tot * (stride - D))
                out = jnp.concatenate([rec, out[:, R_tot * stride :]], axis=1)
            return out

        if n_dev == 1:
            return jax.jit(wrapped)
        mesh = Mesh(np.array(devices), ("chains",))
        return jax.jit(
            jax.shard_map(
                wrapped,
                mesh=mesh,
                in_specs=(P(), P("chains")),
                out_specs=P("chains"),
            )
        )

    import time as _time

    # cumulative epoch-phase timers (seconds) — surfaced via run.timers for
    # the run summary's epoch_timers
    timers = {"pack": 0.0, "enqueue": 0.0, "fetch": 0.0, "expand": 0.0,
              "unpack": 0.0}

    # the compiled engine, plus the lazily compiled scan engine that re-runs
    # an overflowed ring epoch.  A failure of the requested engine raises.
    engines = {"ring_reruns": 0}

    ekey = (
        calc, cfg, B, n_dev, bool(single_device),
        None if single_device else tuple(devices), str(real_dtype()),
    )

    def _cached_engine(kind, builder):
        k = (kind, ekey)
        if k not in _ENGINE_CACHE:
            _cache_put(_ENGINE_CACHE, k, compile_engine(builder()))
        return _ENGINE_CACHE[k]

    engines["current"] = _cached_engine(
        "primary", lambda: build_epoch_fn(calc, cfg, axis_name=axis)
    )

    # multi-host (jax.distributed): every process holds the identical full
    # host state (redundant-deterministic administration, SURVEY §5.8); the
    # batch is sharded over the global mesh and results allgathered back.
    n_proc = jax.process_count()
    multihost = n_proc > 1 and not single_device

    def to_device(packed_in):
        if not multihost:
            return jnp.asarray(packed_in)
        from jax.experimental import multihost_utils as mhu

        mesh = Mesh(np.array(devices), ("chains",))
        p = jax.process_index()
        rows = packed_in.shape[0] // n_proc
        local = packed_in[p * rows : (p + 1) * rows]
        return mhu.host_local_array_to_global_array(local, mesh, P("chains"))

    def fetch(packed_out):
        if not multihost:
            return np.asarray(packed_out)
        from jax.experimental import multihost_utils as mhu

        return np.asarray(mhu.process_allgather(packed_out, tiled=True))

    def scan_rerun():
        if "scan" not in engines:
            engines["scan"] = _cached_engine(
                "scan", lambda: build_epoch_fn_scan(calc, cfg, axis_name=axis)
            )
        return engines["scan"]

    def dispatch(key, seed_cube, bound, chol):
        """Enqueue one epoch on the device WITHOUT blocking (JAX async
        dispatch) — the host consumes the previous nursery while the device
        computes, the reference's async administrator/worker overlap
        (nested_sampling.F90:288-313)."""
        t0 = _time.time()
        packed_in = pack_inputs(
            np.asarray(seed_cube, dtype=real_dtype()),
            np.asarray(bound, dtype=real_dtype()),
            np.asarray(chol, dtype=real_dtype()),
        )
        timers["pack"] += _time.time() - t0
        t0 = _time.time()
        out = engines["current"](key, to_device(packed_in))
        timers["enqueue"] += _time.time() - t0
        return (key, packed_in, out)

    def expand(packed_out):
        """Re-insert the theta columns dropped by the compact fetch."""
        if not compact:
            return packed_out
        n = packed_out.shape[0]
        crec = packed_out[:, : R_tot * (stride - D)].reshape(
            n, R_tot, stride - D
        )
        cube = crec[:, :, :D]
        theta = calc.theta_batch_host(
            cube.reshape(-1, D)
        ).reshape(n, R_tot, D)
        full = np.empty((n, R_tot, stride), dtype=packed_out.dtype)
        full[:, :, :D] = cube
        full[:, :, D : 2 * D] = theta
        full[:, :, 2 * D :] = crec[:, :, D:]
        return np.concatenate(
            [full.reshape(n, R_tot * stride),
             packed_out[:, R_tot * (stride - D) :]],
            axis=1,
        )

    def collect(handle):
        """Block on a dispatched epoch and unpack its nursery."""
        key, packed_in, out = handle
        t0 = _time.time()
        packed_out = fetch(out)
        if cfg.engine == "ring" and epoch_overflowed(packed_out):
            # a pathological epoch exhausted the ring: re-run it with the
            # scan engine (bitwise-identical results, no slot budget).  The
            # ring engine stays current; the rerun is counted so the run
            # summary can report it.
            engines["ring_reruns"] += 1
            packed_out = fetch(scan_rerun()(key, to_device(packed_in)))
        timers["fetch"] += _time.time() - t0
        t0 = _time.time()
        expanded = expand(packed_out)
        timers["expand"] += _time.time() - t0
        t0 = _time.time()
        res = unpack_epoch(expanded, cfg)
        timers["unpack"] += _time.time() - t0
        return res

    def run(key, seed_cube, bound, chol):
        return collect(dispatch(key, seed_cube, bound, chol))

    # ---- chained epochs ("turbo", ops/chained_epoch.py): K epochs + the
    # live-set consume loop in ONE dispatch, for synchronous single-device
    # runs.
    def dispatch_chain(key, live_cube, live_logL, chol1, K):
        """Enqueue a K-epoch chain (single-device, compact-fetch calcs
        only): ONE packed upload, async dispatch."""
        from ..ops.chained_epoch import build_chained_fn, pack_chain_blob

        nlive = live_cube.shape[0]
        sig = (calc, cfg, B, int(K), int(nlive), str(real_dtype()))
        if sig not in _CHAIN_CACHE:
            _cache_put(
                _CHAIN_CACHE, sig, build_chained_fn(calc, cfg, B, K, nlive)
            )
        fn = _CHAIN_CACHE[sig]
        t0 = _time.time()
        blob = jnp.asarray(pack_chain_blob(key, chol1, live_cube, live_logL))
        timers["pack"] += _time.time() - t0
        t0 = _time.time()
        flat = fn(blob)
        timers["enqueue"] += _time.time() - t0
        return (flat, int(K), int(nlive))

    def collect_chain(handle):
        """Block on a chain and unpack its K nurseries.  Returns
        (nurseries, final_live_logL): nurseries is a list of
        (cube, theta, phi, logL, nlike, bound0) per epoch in order."""
        flat, K, nlive = handle
        W = R_tot * (stride - D) + tail if compact else R_tot * stride + tail
        t0 = _time.time()
        flat = np.asarray(flat)
        timers["fetch"] += _time.time() - t0
        packs = flat[: K * B * W].reshape(K, B, W)
        bounds = flat[K * B * W : K * B * W + K]
        final_ll = flat[K * B * W + K :]
        nurseries = []
        for k in range(K):
            t0 = _time.time()
            expanded = expand(packs[k])
            timers["expand"] += _time.time() - t0
            t0 = _time.time()
            cube, theta, phi, logL, nlike = unpack_epoch(expanded, cfg)
            timers["unpack"] += _time.time() - t0
            nurseries.append(
                (cube, theta, phi, logL, nlike, float(bounds[k]))
            )
        return nurseries, final_ll

    run.dispatch = dispatch
    run.collect = collect
    run.dispatch_chain = dispatch_chain
    run.collect_chain = collect_chain
    run.engine_used = lambda: cfg.engine
    run.timers = timers
    run.ring_reruns = lambda: engines["ring_reruns"]
    run._engines = engines  # test hook (forced-failure tests)
    return run, B
