#!/usr/bin/env python3
"""On-card smoke test: the sampler's main path on NVIDIA GPUs.

    python chip_smoke.py           phases 0-5 on one card
    python chip_smoke.py --four    the four-card phase only (needs 4 cards)

Phases (one process; every check prints a line, and a failed check raises,
which ends the run with a non-zero exit):

0. device: JAX's first device must be a GPU; prints the card, JAX and XLA
   settings and the compile-cache directory.
1. flagship epoch: the 20-D Gaussian slice epoch at B=8192, R=100 (scan
   engine) — compile time, memory analysis, one epoch's time; contour,
   ball-moment and likelihood-count checks; the same epoch at B=512 on the
   CPU as the plain reference; Gram-Schmidt directions against a float64
   numpy QR.
2. end to end: ``polychordlite_tpu.run`` on a normalised 20-D Gaussian to
   termination, logZ against the analytic value.
3. ini and multimodal: ``run_ini`` on ``ini/gaussian_shells.ini``, the
   two-shell oracle of ``tests/test_multimodal.py``.
4. host likelihood: a numpy 4-D Gaussian through ``run()``.
5. float64: ``precision="highest"`` on the card.

``--four`` runs only the four-card phase: the flagship epoch's global batch
on one card against four, and ``run()`` with ``mesh_shape=4`` against
``mesh_shape=1``.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import shutil
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402

import bench  # noqa: E402
import polychordlite_tpu  # noqa: E402
from bench import nvidia_smi, require_gpu  # noqa: E402
from polychordlite_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

OUT_DIR = os.path.join(REPO, "chains", "chip_smoke")


class CheckFailed(AssertionError):
    """A smoke-test check did not hold."""


def check(name: str, ok: bool, detail: str) -> None:
    print(f"  [{'pass' if ok else 'FAIL'}] {name}: {detail}", flush=True)
    if not ok:
        raise CheckFailed(f"{name}: {detail}")


def contract_line(devices) -> str:
    """The last line of a passing run."""
    return json.dumps(
        {
            "ok": True,
            "device": {
                "platform": devices[0].platform,
                "kind": devices[0].device_kind,
                "count": len(devices),
            },
        }
    )


def phase_device():
    import jax

    print("phase 0: device", flush=True)
    devices = jax.devices()
    require_gpu(devices)
    cache_dir = enable_compile_cache()
    print(f"  device_kind: {devices[0].device_kind}")
    print(f"  device count: {len(devices)}")
    print(f"  nvidia-smi: {nvidia_smi()}")
    print(f"  jax {jax.__version__}")
    print(f"  XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    print(f"  compile cache: {cache_dir}", flush=True)
    return devices


def _epoch_on(calc, cfg, args, device):
    """Compile the jitted epoch for ``device``; returns (compiled, placed
    args, compile seconds)."""
    import jax

    from polychordlite_tpu.ops.slice_kernel import build_epoch_fn

    placed = jax.device_put(args, device)
    t0 = time.perf_counter()
    compiled = jax.jit(build_epoch_fn(calc, cfg)).lower(*placed).compile()
    return compiled, placed, time.perf_counter() - t0


def _r2_ratio(cube_last):
    """Mean squared radius of babies about the centre, over R0^2 D/(D+2)."""
    D = cube_last.shape[1]
    r2 = ((cube_last - 0.5) ** 2).sum(axis=1)
    return r2.mean() / (bench.R0**2 * D / (D + 2))


def _r2_ratio_se(n_dims, n_lanes):
    """Standard error of :func:`_r2_ratio` over independent lanes: for a
    point uniform in a D-ball, r^2/r0^2 ~ Beta(D/2, 1)."""
    a = n_dims / 2
    return math.sqrt(1 / (a * (a + 2)) / n_lanes)


def _compare_nurseries(label, a, b, n_dims):
    """Check nursery ``a`` against nursery ``b`` of the same inputs (both as
    :func:`unpack_epoch` returns them).

    A lane follows the other until one decision flips on a last-bit
    rounding difference, after which it is a different (equally valid)
    chain.  So the first repeat's babies are compared lane by lane, and the
    last repeat and the evaluation counts statistically."""
    n = a[0].shape[0]
    dcube = np.abs(a[0][:, 0] - b[0][:, 0]).max(axis=1)
    same = (dcube < 1e-4) & (np.abs(a[3][:, 0] - b[3][:, 0]) < 1e-3)
    check(f"{label}, first repeat", same.mean() >= 0.98,
          f"{same.mean():.4f} of {n} lanes agree to 1e-4 (need 0.98: a "
          f"decision can flip on the last bit); median |cube diff| "
          f"{np.median(dcube):.3g}")
    ra, rb = _r2_ratio(a[0][:, -1]), _r2_ratio(b[0][:, -1])
    tol = 5 * math.sqrt(2) * _r2_ratio_se(n_dims, n)
    check(f"{label}, last-repeat moment", abs(ra - rb) < tol,
          f"{ra:.5f} vs {rb:.5f}, tolerance {tol:.4f} (5 standard errors "
          f"of the difference)")
    na, nb = int(a[4].sum()), int(b[4].sum())
    check(f"{label}, evaluations", abs(na / nb - 1) < 0.05,
          f"{na} vs {nb} likelihood evals (within 5%)")


def phase_flagship(device, ref_device, B=8192, ref_B=512, n_dims=20,
                   num_repeats=100, n_bases=4096):
    """Flagship epoch on ``device``, checked and compared with the same
    jitted epoch on ``ref_device``."""
    import jax

    from polychordlite_tpu.ops.directions import _gram_schmidt
    from polychordlite_tpu.ops.slice_kernel import unpack_epoch

    print(f"phase 1: flagship epoch (B={B}, D={n_dims}, R={num_repeats}, "
          f"scan) on {device.device_kind}", flush=True)
    calc, cfg, args = bench.flagship_epoch(B, n_dims, num_repeats)
    bound = float(args[2][0])
    compiled, placed, compile_s = _epoch_on(calc, cfg, args, device)
    print(f"  compile: {compile_s:.3f} s")
    print(f"  memory_analysis: {compiled.memory_analysis()}")
    jax.block_until_ready(compiled(*placed))  # first run
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*placed))
    epoch_s = time.perf_counter() - t0
    cube, _, _, logL, nlike = unpack_epoch(np.asarray(out), cfg)
    n = int(nlike.sum())
    print(f"  one epoch: {epoch_s:.6f} s, {n} likelihood evals, "
          f"{n / epoch_s:.6g} evals/s", flush=True)
    check("contour", bool((logL >= bound).all()),
          f"min baby logL {logL.min():.6f} >= bound {bound:.6f}")
    check("nlike", n > 0, f"{n} evaluations")
    # babies of the last repeat are uniform in the ball: E[r^2] is known.
    # Tolerance: 5 standard errors over the B independent lanes (0.5% at
    # B=8192, D=20), plus 0.5% for what R repeats leave of the seeds.
    ratio = _r2_ratio(cube[:, -1])
    tol = 5 * _r2_ratio_se(n_dims, B) + 0.005
    check("ball moment", abs(ratio - 1) < tol,
          f"E[r^2] / (r0^2 D/(D+2)) = {ratio:.5f}, tolerance {tol:.4f}")

    # plain reference: the same jitted epoch on the CPU, same keys, at ref_B
    calc, cfg, args = bench.flagship_epoch(ref_B, n_dims, num_repeats)
    dev_c, dev_args, _ = _epoch_on(calc, cfg, args, device)
    ref_c, ref_args, _ = _epoch_on(calc, cfg, args, ref_device)
    _compare_nurseries(
        f"device vs {ref_device.platform} reference",
        unpack_epoch(np.asarray(dev_c(*dev_args)), cfg),
        unpack_epoch(np.asarray(ref_c(*ref_args)), cfg),
        n_dims,
    )

    # directions: device Gram-Schmidt against a float64 numpy QR of the
    # same Gaussian draws.  Float32 Gram-Schmidt loses orthogonality in
    # proportion to the draw's condition number kappa (twice is enough only
    # while eps * kappa << 1), so each basis must reach 1e-5 or, where kappa
    # makes that unreachable in float32, 4 eps kappa.
    gauss = np.random.default_rng(1).standard_normal(
        (n_bases, n_dims, n_dims)).astype(np.float32)
    q = np.asarray(jax.jit(_gram_schmidt)(jax.device_put(gauss, device)),
                   np.float64)
    g64 = gauss.astype(np.float64)
    q64, r64 = np.linalg.qr(g64)
    q64 = q64 * np.sign(np.einsum("bii->bi", r64))[:, None, :]
    limit = np.maximum(
        1e-5, 4 * np.finfo(np.float32).eps * np.linalg.cond(g64))
    orth = np.abs(np.einsum("bdk,bdj->bkj", q, q) - np.eye(n_dims)).max(
        axis=(1, 2))
    dq = np.abs(q - q64).max(axis=(1, 2))
    check("directions orthonormal", bool((orth <= limit).all()),
          f"max |Q^T Q - I| median {np.median(orth):.3g}, worst "
          f"{orth.max():.3g}; {(orth < 1e-5).mean():.4f} of {n_bases} "
          f"bases within 1e-5, all within max(1e-5, 4 eps kappa)")
    check("directions vs float64 QR", bool((dq <= limit).all()),
          f"max |Q - Q_qr| median {np.median(dq):.3g}, worst "
          f"{dq.max():.3g}; all within max(1e-5, 4 eps kappa)")


def gaussian20(n_dims=20, sigma=0.1):
    """Normalised Gaussian at the origin; on U[-1,1]^D, logZ = -D log 2."""
    import jax.numpy as jnp

    norm = -n_dims * math.log(sigma * math.sqrt(2 * math.pi))

    def loglikelihood(theta):
        return norm - jnp.sum(theta**2) / (2 * sigma**2)

    return loglikelihood


def _run_and_read(like, n_dims, file_root, out_dir, **kw):
    """``polychordlite_tpu.run`` with the reference defaults; returns
    (logZ, logZerr, ndead, nlike, wall seconds, final metrics record)."""
    from polychordlite_tpu.output import PolyChordOutput
    from polychordlite_tpu.priors import UniformPrior

    settings = dict(
        prior=UniformPrior(-1.0, 1.0),
        nlive=25 * n_dims,
        num_repeats=5 * n_dims,
        precision_criterion=1e-3,
        base_dir=out_dir,
        file_root=file_root,
        read_resume=False,
        seed=11,
        feedback=0,
    )
    settings.update(kw)
    t0 = time.perf_counter()
    polychordlite_tpu.run(like, n_dims, **settings)
    wall = time.perf_counter() - t0
    out = PolyChordOutput(out_dir, file_root)
    with open(os.path.join(out_dir, file_root + ".metrics.jsonl")) as f:
        last = json.loads(f.readlines()[-1])
    return out.logZ, out.logZerr, out.ndead, out.nlike, wall, last


def _check_logZ(name, logZ, logZerr, analytic):
    tol = 3 * logZerr + 0.1
    check(name, abs(logZ - analytic) < tol,
          f"logZ {logZ:.4f} +/- {logZerr:.4f} vs analytic {analytic:.4f} "
          f"(|diff| {abs(logZ - analytic):.4f} < 3 sigma + 0.1 = {tol:.4f})")


def phase_end_to_end(out_dir, device, n_dims=20):
    print(f"phase 2: run() to termination, {n_dims}-D Gaussian on "
          f"U[-1,1]^{n_dims}, nlive={25 * n_dims}, num_repeats={5 * n_dims}",
          flush=True)
    logZ, logZerr, ndead, nlike, wall, last = _run_and_read(
        gaussian20(n_dims), n_dims, "gaussian", out_dir
    )
    print(f"  ndead {ndead}, nlike {nlike}, wall {wall:.3f} s (compile "
          f"included), {ndead / wall:.6g} dead/s, engine_used "
          f"{last['engine']}, chained epochs {last['chained_epochs']}, "
          f"epochs on {last['epoch_devices']} {last['epoch_platform']} "
          f"device(s)", flush=True)
    check("epochs on the card", last["epoch_platform"] == device.platform,
          f"platform {last['epoch_platform']}")
    _check_logZ("logZ", logZ, logZerr, -n_dims * math.log(2.0))


def phase_ini(out_dir):
    """``run_ini`` on the reference's two-shell problem, in this process."""
    from polychordlite_tpu.core.rti import calculate_logZ_estimate
    from polychordlite_tpu.inidriver import run_ini

    print("phase 3: run_ini(ini/gaussian_shells.ini), clustering", flush=True)
    with open(os.path.join(REPO, "ini", "gaussian_shells.ini")) as f:
        text = f.read()
    ini = os.path.join(out_dir, "gaussian_shells.ini")
    with open(ini, "w") as f:
        f.write(text.replace("base_dir = chains",
                             f"base_dir = {out_dir}/shells")
                .replace("feedback = 1", "feedback = 0\nseed = 17"))
    t0 = time.perf_counter()
    res = run_ini(ini)
    wall = time.perf_counter() - t0
    rti = res["rti"]
    print(f"  ndead {res['ndead']}, nlike {res['nlike']}, wall {wall:.3f} s, "
          f"engine_used {res['metrics']['engine_used']}", flush=True)
    # the oracle of tests/test_multimodal.py: global evidence, and each
    # shell's local evidence Z/2 from the retired clusters on that side
    analytic = -math.log(12.0 * 5.0)
    tol = 2 * res["logZerr"] + 0.05
    check("logZ", abs(res["logZ"] - analytic) < tol,
          f"{res['logZ']:.4f} +/- {res['logZerr']:.4f} vs {analytic:.4f} "
          f"(need |diff| < 2 sigma + 0.05 = {tol:.4f})")
    _, _, _, _, lz, _ = calculate_logZ_estimate(rti)
    lz = np.asarray(lz)
    xs = []
    for post in rti.posterior_dead:
        if post.shape[0]:
            w = np.exp(post[:, 2] + post[:, 1]
                       - (post[:, 2] + post[:, 1]).max())
            xs.append(float((w * post[:, 4]).sum() / w.sum()))
        else:
            xs.append(0.0)
    xs = np.asarray(xs)
    ok = np.isfinite(lz) & (lz > -1e29)
    check("clusters", ok.sum() >= 2, f"{int(ok.sum())} clusters with evidence")
    expected = res["logZ"] - math.log(2.0)
    for side in (-1, 1):
        sel = ok & (np.sign(xs) == side)
        check(f"shell at x={3.5 * side:+.1f} found", bool(sel.any()),
              f"{int(sel.sum())} clusters")
        v = lz[sel]
        local = v.max() + math.log(np.sum(np.exp(v - v.max())))
        tol = 2 * res["logZerr"] + 0.25
        check(f"shell at x={3.5 * side:+.1f} local evidence",
              abs(local - expected) < tol,
              f"{local:.4f} vs logZ - log 2 = {expected:.4f} "
              f"(need < {tol:.4f})")
    v = lz[ok]
    total = v.max() + math.log(np.sum(np.exp(v - v.max())))
    check("local evidences sum to global", abs(total - res["logZ"]) < 0.5,
          f"{total:.4f} vs {res['logZ']:.4f}")


def phase_host_likelihood(out_dir, n_dims=4, sigma=0.1):
    print(f"phase 4: numpy (host) {n_dims}-D Gaussian through run()",
          flush=True)
    norm = -n_dims * math.log(sigma * math.sqrt(2 * math.pi))

    def prior(cube):
        return -1.0 + 2.0 * np.asarray(cube)

    def loglikelihood(theta):
        theta = np.asarray(theta)  # numpy only: not traceable by JAX
        return float(norm - np.sum(theta**2) / (2 * sigma**2))

    logZ, logZerr, ndead, nlike, wall, last = _run_and_read(
        loglikelihood, n_dims, "host_gaussian", out_dir, prior=prior,
        nlive=100,
    )
    print(f"  epochs ran on {last['epoch_devices']} {last['epoch_platform']} "
          f"device(s); ndead {ndead}, nlike {nlike}, wall {wall:.3f} s",
          flush=True)
    check("host likelihood epochs on the host CPU",
          last["epoch_platform"] == "cpu", f"{last['epoch_platform']}")
    _check_logZ("logZ", logZ, logZerr, -n_dims * math.log(2.0))


def phase_f64(out_dir, device, n_dims=4):
    import jax
    import jax.numpy as jnp

    from polychordlite_tpu.ops.evaluate import make_batched_calculator
    from polychordlite_tpu.ops.precision import real_dtype, set_real_dtype
    from polychordlite_tpu.ops.slice_kernel import EpochConfig
    from polychordlite_tpu.parallel.mesh import make_epoch_runner
    from polychordlite_tpu.priors import UniformPrior

    print(f"phase 5: precision='highest' (float64) {n_dims}-D Gaussian",
          flush=True)
    like, prior = gaussian20(n_dims), UniformPrior(-1.0, 1.0)
    # the nursery dtype and placement of run()'s own epoch runner
    before = real_dtype()
    with jax.enable_x64(True):
        set_real_dtype(jnp.float64)
        try:
            calc = make_batched_calculator(prior, like, n_dims, 0)
            cfg = EpochConfig(n_dims=n_dims, n_phi=1, grade_dims=(n_dims,),
                              num_repeats=(5 * n_dims,))
            runner, B = make_epoch_runner(calc, cfg, 64, devices=[device])
            _, _, out = runner.dispatch(
                jax.random.PRNGKey(0), np.full((B, n_dims), 0.5),
                np.full((B,), -1e3), np.broadcast_to(
                    0.1 * np.eye(n_dims), (B, n_dims, n_dims)),
            )
            out = jax.block_until_ready(out)
        finally:
            set_real_dtype(before)
    platforms = {d.platform for d in out.devices()}
    check("float64 nursery",
          out.dtype == np.float64 and platforms == {device.platform},
          f"dtype {out.dtype} on {platforms}")
    logZ, logZerr, ndead, nlike, wall, last = _run_and_read(
        like, n_dims, "f64_gaussian", out_dir, precision="highest",
        nlive=100,
    )
    print(f"  ndead {ndead}, nlike {nlike}, wall {wall:.3f} s, epochs on "
          f"{last['epoch_platform']}", flush=True)
    check("epochs on the card", last["epoch_platform"] == device.platform,
          f"platform {last['epoch_platform']}")
    _check_logZ("logZ", logZ, logZerr, -n_dims * math.log(2.0))


def phase_four(devices, out_dir, B=8192, n_dims=20, num_repeats=100,
               run_dims=20):
    """The flagship epoch's global batch on 1 device and on 4, then run()
    over a 4-device mesh against one device.

    The per-lane random streams do not depend on the sharding, and on the
    CPU the nurseries are bitwise equal.  On GPUs XLA picks kernels per
    shape, so a (B/4)-lane shard can round differently in the last bit
    from the B-lane batch (the directions differ by ~1 ulp); the nurseries
    are then compared as the device is with its CPU reference."""
    from polychordlite_tpu.parallel.mesh import make_epoch_runner

    print(f"phase four: B={B} sharded over {len(devices[:4])} devices",
          flush=True)
    calc, cfg, (key, seeds, bounds, chol, _) = bench.flagship_epoch(
        B, n_dims, num_repeats)
    outs, times = {}, {}
    for n in (1, 4):
        runner, B_run = make_epoch_runner(calc, cfg, B, devices=devices[:n])
        assert B_run == B
        runner(key, seeds, bounds, chol)  # compile and warm
        t0 = time.perf_counter()
        outs[n] = runner(key, seeds, bounds, chol)
        times[n] = time.perf_counter() - t0
        print(f"  {n} device(s): epoch incl. transfers {times[n]:.6f} s",
              flush=True)
    names = ("cube", "theta", "phi", "logL", "nlike")
    diffs = {
        k: float(np.abs(a - b).max())
        for k, a, b in zip(names, outs[1], outs[4])
    }
    equal = all(np.array_equal(a, b) for a, b in zip(outs[1], outs[4]))
    lanes = np.mean([
        np.array_equal(outs[1][0][i], outs[4][0][i]) for i in range(B)
    ])
    print(f"  bitwise equal: {equal}; lanes identical: {lanes:.4f}; "
          f"max |diff| {diffs}", flush=True)
    _compare_nurseries("4 vs 1 devices", outs[4], outs[1], n_dims)

    def run_on(n):
        return _run_and_read(gaussian20(run_dims), run_dims, f"mesh{n}",
                             out_dir, mesh_shape=n)

    r1, r4 = run_on(1), run_on(4)
    for n, r in ((1, r1), (4, r4)):
        print(f"  mesh_shape={n}: logZ {r[0]:.4f} +/- {r[1]:.4f}, ndead "
              f"{r[2]}, wall {r[4]:.3f} s, epochs on {r[5]['epoch_devices']}"
              f" device(s), chained epochs {r[5]['chained_epochs']}",
              flush=True)
    tol = 3 * math.hypot(r1[1], r4[1])
    check("logZ, 4 vs 1 devices", abs(r1[0] - r4[0]) < tol,
          f"|diff| {abs(r1[0] - r4[0]):.4f} < 3 combined sigma {tol:.4f}")
    check("mesh run used 4 devices", r4[5]["epoch_devices"] == 4,
          f"{r4[5]['epoch_devices']}")


def main(argv=None) -> int:
    import jax

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card phase")
    ap.add_argument("--out", default=OUT_DIR,
                    help="directory for the runs' files (emptied first)")
    args = ap.parse_args(argv)

    devices = phase_device()
    shutil.rmtree(args.out, ignore_errors=True)
    os.makedirs(args.out)
    t0 = time.perf_counter()
    if args.four:
        if len(devices) < 4:
            raise CheckFailed(f"--four needs 4 GPUs, found {len(devices)}")
        devices = devices[:4]
        phase_four(devices, args.out)
    else:
        devices = devices[:1]
        phase_flagship(devices[0], jax.devices("cpu")[0])
        phase_end_to_end(args.out, devices[0])
        phase_ini(args.out)
        phase_host_likelihood(args.out)
        phase_f64(args.out, devices[0])
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s")
    print(f"nvidia-smi: {nvidia_smi()}")
    print(contract_line(devices), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
