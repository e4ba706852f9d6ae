"""Profile the flagship slice epoch on one GPU.

Measures, at the geometry of ``bench.FLAGSHIP`` (20-D Gaussian, B=8192,
R=100, scan engine):

* compile time of the jitted epoch;
* time per epoch, each epoch timed on its own with ``block_until_ready``;
* inner ``while_loop`` trips per epoch (the scan engine reports them in its
  tail column) and the lanes' mean evaluations per repeat, whose ratio to
  the trips per repeat measures lockstep efficiency;
* from a ``jax.profiler`` trace of one epoch: device kernels per loop trip
  and the device's idle share inside the epoch (see :func:`reduce_trace`);
* the direction-generation layer's share of the epoch (``make_directions``
  timed alone at the same shapes).

Prints one JSON line with the device it ran on.  A device that is not a GPU
is an error.

Usage: python benchmarks/profile_epoch.py [--epochs N] [--trace-dir DIR]
"""

from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import bench  # noqa: E402


def _union_ns(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def reduce_trace(profile, top=12) -> dict:
    """Device activity of a traced window, from a ``ProfileData``.

    Device events are those on the ``Stream`` lines of ``/device:GPU:*``
    planes (other lines of those planes repeat the same spans grouped by
    XLA module or op).  The window runs from the first device event's start
    to the last one's end; busy time is the union of the event intervals,
    and the idle share is 1 - busy / window.  Kernels are the events whose
    name is not a memory copy or set."""
    events = []
    for plane in profile.planes:
        if not plane.name.startswith("/device:GPU:"):
            continue
        for line in plane.lines:
            if not line.name.startswith("Stream"):
                continue
            for ev in line.events:
                events.append((ev.name, ev.start_ns, ev.duration_ns))
    if not events:
        raise ValueError("the trace holds no GPU stream events")
    start = min(s for _, s, _ in events)
    end = max(s + d for _, s, d in events)
    busy = _union_ns([(s, s + d) for _, s, d in events])
    is_copy = [
        any(w in name.lower() for w in ("memcpy", "memset")) for name, _, _
        in events
    ]
    by_name = collections.defaultdict(lambda: [0, 0.0])
    for name, _, d in events:
        by_name[name][0] += 1
        by_name[name][1] += d
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:top]
    return {
        "device_events": len(events),
        "kernels": len(events) - sum(is_copy),
        "copies": sum(is_copy),
        "window_ns": end - start,
        "busy_ns": busy,
        "idle_share": 1.0 - busy / (end - start),
        "top_events": [
            {"name": n[:120], "count": c, "total_ns": t}
            for n, (c, t) in ranked
        ],
    }


def main():
    import jax

    from polychordlite_tpu.ops.directions import make_directions
    from polychordlite_tpu.ops.slice_kernel import (
        _lane_keys,
        build_epoch_fn,
        epoch_loop_trips,
        unpack_epoch,
    )
    from polychordlite_tpu.utils.compile_cache import enable_compile_cache

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--epochs", type=int, default=5)
    ap.add_argument("--trace-dir",
                    default=os.path.join(REPO, "build", "trace_epoch"))
    args = ap.parse_args()

    cache_dir = enable_compile_cache()
    where = bench.device_fields()
    calc, cfg, inputs = bench.flagship_epoch(**bench.FLAGSHIP)
    B, R = bench.FLAGSHIP["B"], cfg.total_repeats
    placed = jax.device_put(inputs)
    key, _, _, chol, _ = placed

    t0 = time.perf_counter()
    epoch = jax.jit(build_epoch_fn(calc, cfg)).lower(*placed).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(epoch(*placed))  # first run

    times, trips, nlikes = [], [], []
    for i in range(args.epochs):
        k = jax.random.fold_in(key, i + 1)
        t0 = time.perf_counter()
        out = jax.block_until_ready(epoch(k, *placed[1:]))
        times.append(time.perf_counter() - t0)
        trips.append(epoch_loop_trips(out))
        nlikes.append(int(unpack_epoch(np.asarray(out), cfg)[4].sum()))

    # direction generation alone, at the epoch's shapes
    dir_keys = _lane_keys(key, B, None)[0]
    dirs = jax.jit(
        lambda k, c: make_directions(
            k, c, grade_dims=cfg.grade_dims, num_repeats=cfg.num_repeats,
            n_dims=cfg.n_dims, shared_perm_key=jax.random.fold_in(key, 1),
        )
    )
    jax.block_until_ready(dirs(dir_keys, chol))
    dir_times = []
    for _ in range(args.epochs):
        t0 = time.perf_counter()
        jax.block_until_ready(dirs(dir_keys, chol))
        dir_times.append(time.perf_counter() - t0)

    # one traced epoch (its end-to-end time is not used: tracing slows it)
    k = jax.random.fold_in(key, 1)
    jax.profiler.start_trace(args.trace_dir)
    with jax.profiler.TraceAnnotation("flagship_epoch"):
        jax.block_until_ready(epoch(k, *placed[1:]))
    jax.profiler.stop_trace()
    path = sorted(glob.glob(os.path.join(
        args.trace_dir, "plugins", "profile", "*", "*.xplane.pb")))[-1]
    trace = reduce_trace(jax.profiler.ProfileData.from_file(path))

    epoch_s = float(np.median(times))
    mean_iters = float(np.mean(nlikes)) / (B * R)
    result = {
        **where,
        "geometry": bench.FLAGSHIP,
        "engine": "scan",
        "compile_s": compile_s,
        "epoch_s": times,
        "epoch_s_median": epoch_s,
        "evals_per_s": float(np.mean(nlikes)) / epoch_s,
        "loop_trips_per_epoch": trips,
        "trips_per_repeat": float(np.mean(trips)) / R,
        "lane_evals_per_repeat": mean_iters,
        "evals_per_lane_trip": mean_iters / (float(np.mean(trips)) / R),
        "directions_s_median": float(np.median(dir_times)),
        "directions_share": float(np.median(dir_times)) / epoch_s,
        "trace": {
            **trace,
            "kernels_per_trip": trace["kernels"] / trips[0],
            "path": os.path.relpath(path, REPO),
        },
        "compile_cache_dir": cache_dir,
        "memory_stats": {
            name: v
            for name, v in (jax.devices()[0].memory_stats() or {}).items()
            if name in ("peak_bytes_in_use", "bytes_limit")
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
