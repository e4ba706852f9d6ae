"""Benchmark: likelihood evals/s on one GPU for the 20-D Gaussian slice epoch.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...extras},
with the device it ran on (platform, device_kind, device count, and the
card's name and power limit from ``nvidia-smi``).  It fails on a device that
is not a GPU.

Baseline: the Fortran reference cannot be built here (no gfortran), so
``csrc/slice_baseline.c`` re-creates its per-core hot loop (whitened slice
sampling on the 20-D normalised Gaussian, chordal_sampling.f90 semantics) at
native -O3 speed; the 16-rank MPI figure of BASELINE.md is 16x the measured
single-core rate.  ``vs_baseline`` = device evals/s / that figure.  The
baseline is built from the committed ``csrc/`` with gcc; a missing
toolchain is an error.

Extras: dead-points/s and |logZ - analytic| from a short end-to-end 4-D
quickstart run.

Usage: python bench.py
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
BUILD = os.path.join(REPO, "build")
CHAINS = os.path.join(REPO, "chains", "bench")

# flagship slice epoch: 20-D normalised Gaussian, nursery B, R repeats
FLAGSHIP = dict(B=8192, n_dims=20, num_repeats=100)
# contour radius of the flagship epoch: a ball of radius 0.45 around the
# Gaussian's centre 0.5, inside the unit cube, so babies are uniform in it
# and E[r^2] = R0^2 D / (D + 2)
R0 = 0.45


def nvidia_smi() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip()


def require_gpu(devices):
    """Raise unless JAX's first device is a GPU (no CPU fallback)."""
    if not devices or devices[0].platform != "gpu":
        found = devices[0].platform if devices else "none"
        raise RuntimeError(
            f"needs an NVIDIA GPU: JAX's first device is {found!r}"
        )


def device_fields() -> dict:
    """Where a result was measured: JAX's device and the card's limits."""
    import jax

    devices = jax.devices()
    require_gpu(devices)
    return {
        "platform": devices[0].platform,
        "device_kind": devices[0].device_kind,
        "device_count": len(devices),
        "nvidia_smi": nvidia_smi(),
    }


def c_baseline_rate(seconds: float = 2.0) -> float:
    """Single-core native evals/s of ``csrc/slice_baseline.c``."""
    os.makedirs(BUILD, exist_ok=True)
    exe = os.path.join(BUILD, "slice_baseline_bench")
    src = os.path.join(REPO, "csrc", "slice_baseline.c")
    subprocess.run(
        ["gcc", "-O3", "-march=native", "-o", exe, src, "-lm"],
        check=True, capture_output=True, timeout=60,
    )
    out = subprocess.run(
        [exe, str(seconds)], check=True, capture_output=True, timeout=60
    )
    return float(out.stdout.strip())


def flagship_epoch(B: int, n_dims: int, num_repeats: int, engine="scan"):
    """The flagship slice epoch and a realistic mid-run input state.

    Returns ``(calc, cfg, args)`` with ``args = (key, seeds, bounds, chol,
    valid)``, the inputs of ``build_epoch_fn(calc, cfg)``.  Seeds are
    Gaussian draws clamped inside the contour (in a real run every seed is
    a live point with logL > bound, nested_sampling.F90:245-248); the
    contour is the ball of radius :data:`R0`; the whitening is the true
    covariance.  Inputs are host numpy arrays, so the caller places them."""
    import jax

    from polychordlite_tpu.models import get_likelihood
    from polychordlite_tpu.ops.evaluate import make_batched_calculator
    from polychordlite_tpu.ops.slice_kernel import EpochConfig

    like = get_likelihood("gaussian", n_dims)
    calc = make_batched_calculator(lambda c: c, like, n_dims, n_derived=2)
    cfg = EpochConfig(
        n_dims=n_dims,
        n_phi=calc.n_phi,
        grade_dims=(n_dims,),
        num_repeats=(num_repeats,),
        engine=engine,
    )
    rng = np.random.default_rng(0)
    raw = 0.1 * rng.standard_normal((B, n_dims))
    r = np.sqrt((raw**2).sum(axis=1, keepdims=True))
    seeds = (0.5 + raw * np.minimum(1.0, 0.9 * R0 / r)).astype(np.float32)
    bound = -0.5 * (R0 / 0.1) ** 2 - n_dims * (
        math.log(0.1) + 0.5 * math.log(2 * math.pi)
    )
    bounds = np.full((B,), bound, np.float32)
    chol = np.broadcast_to(
        0.1 * np.eye(n_dims, dtype=np.float32), (B, n_dims, n_dims)
    ).copy()
    valid = np.ones((B,), bool)
    key = np.asarray(jax.random.PRNGKey(0))
    return calc, cfg, (key, seeds, bounds, chol, valid)


def kernel_evals_per_s(n_epochs: int = 5, **geometry):
    """Likelihood evals/s of the flagship epoch on JAX's default device.

    Each epoch is timed on its own with ``block_until_ready`` after a
    compile-and-warm call; the epochs use fresh keys.  Returns
    ``(evals_per_s, compile_s, epoch_s_list)``."""
    import jax

    from polychordlite_tpu.ops.slice_kernel import build_epoch_fn

    geometry = {**FLAGSHIP, **geometry}
    calc, cfg, args = flagship_epoch(**geometry)
    epoch = build_epoch_fn(calc, cfg)
    n_grades = len(cfg.grade_dims)

    @jax.jit
    def counted(key, seeds, bounds, chol, valid):
        packed = epoch(key, seeds, bounds, chol, valid)
        return packed[:, -(n_grades + 1) : -1].sum()

    key, *rest = jax.device_put(args)
    t0 = time.perf_counter()
    compiled = counted.lower(key, *rest).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(key, *rest))  # warm
    evals, times = 0.0, []
    for i in range(n_epochs):
        k = jax.random.fold_in(key, i + 1)
        t0 = time.perf_counter()
        n = jax.block_until_ready(compiled(k, *rest))
        times.append(time.perf_counter() - t0)
        evals += float(n)
    return evals / sum(times), compile_s, times


def quickstart_accuracy():
    """Short end-to-end 4-D quickstart: dead-points/s + logZ error.

    A warm-up run with identical settings triggers every jit compile
    first, so the timed run measures the administrator + device epochs,
    not XLA compilation (the reference's Fortran has no compile step)."""
    import jax.numpy as jnp

    import polychordlite_tpu
    from polychordlite_tpu.priors import UniformPrior

    sigma = 0.1

    def likelihood(theta):
        r2 = jnp.sum(theta**2)
        return (
            -math.log(2 * math.pi * sigma * sigma) * 2.0 - r2 / 2 / sigma**2,
            [r2],
        )

    settings = dict(
        nDerived=1,
        prior=UniformPrior(-1, 1),
        nlive=200,
        read_resume=False,
        write_resume=False,
        base_dir=CHAINS,
        seed=42,
        feedback=0,
        batch_size=192,
    )
    polychordlite_tpu.run(likelihood, 4, file_root="warmup", **settings)
    t0 = time.perf_counter()
    out = polychordlite_tpu.run(
        likelihood, 4, file_root="quickstart", **settings
    )
    dt = time.perf_counter() - t0
    analytic = -4 * math.log(2)
    extras = {
        "dead_points_per_s": out.ndead / dt,
        "logZ_err_vs_analytic": abs(out.logZ - analytic),
        "logZ_sigma": out.logZerr,
        "quickstart_seconds": dt,
        "quickstart_settings": {
            "nlive": 200, "batch_size": 192, "write_resume": False,
            "synchronous": True,
        },
    }
    recs = [
        json.loads(line)
        for line in open(os.path.join(CHAINS, "quickstart.metrics.jsonl"))
    ]
    host_s = sum(sum(r.get("host_breakdown", {}).values()) for r in recs)
    last = recs[-1]
    extras["host_ms_per_dead"] = 1e3 * host_s / max(out.ndead, 1)
    extras["device_frac"] = last["device_frac"]
    extras["quickstart_engine"] = last.get("engine")
    extras["epoch_timers"] = last.get("epoch_timers")
    return extras


def main():
    from polychordlite_tpu.utils.compile_cache import enable_compile_cache

    cache_dir = enable_compile_cache()
    where = device_fields()
    baseline_16rank = 16.0 * c_baseline_rate()
    rate, compile_s, times = kernel_evals_per_s()
    result = {
        "metric": "likelihood evals/s (20D gaussian slice epoch, one GPU)",
        "value": rate,
        "unit": "evals/s",
        "vs_baseline": rate / baseline_16rank,
        **where,
        "engine": "scan",
        "geometry": FLAGSHIP,
        "epoch_seconds": times,
        "compile_seconds": compile_s,
        "baseline_16rank_evals_per_s": baseline_16rank,
        "compile_cache_dir": cache_dir,
        **quickstart_accuracy(),
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
