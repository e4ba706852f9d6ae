"""Evidence calibration sweep: nursery staleness vs the logZ pull.

Sweeps the two staleness knobs on the 4-D quickstart oracle (analytic
logZ = -4 log 2):

  * ``synchronous`` — True: one nursery in flight (seeds current at
    dispatch, reference sync mode); False: dispatch-ahead (babies up to two
    nurseries stale).
  * ``batch_size`` — nursery width B; smaller B = fresher contours per baby.

Runs execute sequentially IN-PROCESS (runs are independent; the jit caches
and the persistent compilation cache amortise across seeds, so a seed costs
seconds instead of a fresh subprocess compile) on whatever backend JAX
selects — the platform and the engine that actually executed are recorded
per row, so the artefact states which shipped configuration it calibrates.

Every attempted (config, seed) produces a row: failures are recorded with
``"failed": true`` and the error, never silently dropped.  Rows are appended to ``calibration_study.jsonl`` as they finish
(the study is resumable / interruption-tolerant); the final summary and all
rows are written to ``benchmarks/calibration_study.json``.

Usage: python benchmarks/calibration_study.py [n_seeds]
"""

import json
import math
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
N_SEEDS = int(sys.argv[1]) if len(sys.argv) > 1 else 64

ANALYTIC = -4 * math.log(2)

# (name, synchronous, batch_size, chain_epochs); chain_epochs=1 is the
# per-epoch dispatch path, -1 auto-engages the chained ("turbo") path on a
# single-device backend — the shipped default there
CONFIGS = [
    ("async_B=nlive", False, 200, 1),
    ("sync_B=nlive", True, 200, 1),
    ("sync_B=nlive/4", True, 56, 1),
    ("async_B=nlive/4", False, 56, 1),
    ("sync_turbo_B=nlive", True, 200, -1),
]

JSONL = os.path.join(REPO, "benchmarks", "calibration_study.jsonl")
OUT = os.path.join(REPO, "benchmarks", "calibration_study.json")


def run_one(seed, sync, bs, chain_epochs=1):
    import jax.numpy as jnp

    import polychordlite_tpu
    from polychordlite_tpu.priors import UniformPrior

    def lik(theta):
        return (
            -jnp.sum((theta / 0.1) ** 2) / 2
            - 4 * math.log(0.1 * math.sqrt(2 * math.pi)),
            [jnp.sum(theta**2)],
        )

    out = polychordlite_tpu.run(
        lik, 4, nDerived=1, prior=UniformPrior(-1, 1), nlive=200,
        read_resume=False, write_resume=False, posteriors=False, equals=False,
        write_live=False, write_dead=False, write_stats=False,
        write_prior=False,
        base_dir="/tmp/calib_%d_%d_%d_%d" % (seed, sync, bs, chain_epochs),
        seed=seed, feedback=-1, synchronous=sync, batch_size=bs,
        chain_epochs=chain_epochs,
    )
    return {
        "logZ": out.logZ,
        "logZerr": out.logZerr,
        "ndead": out.ndead,
        "engine": getattr(out, "metrics", {}).get("engine_used"),
    }


def main():
    import jax

    from polychordlite_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    platform = jax.devices()[0].platform
    try:
        rev = subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
    except Exception:
        rev = "unknown"

    # resume: skip (config, seed) pairs already recorded
    done = set()
    rows = []
    if os.path.exists(JSONL):
        for line in open(JSONL):
            try:
                r = json.loads(line)
            except Exception:
                continue
            rows.append(r)
            done.add((r["config"], r["seed"]))

    t_start = time.time()
    for name, sync, bs, ce in CONFIGS:
        for i in range(N_SEEDS):
            seed = i + 1
            if (name, seed) in done:
                continue
            row = {"config": name, "seed": seed, "synchronous": sync,
                   "batch_size": bs, "chain_epochs": ce}
            try:
                row.update(run_one(seed, sync, bs, ce))
                row["failed"] = False
            except Exception as e:
                row["failed"] = True
                row["error"] = f"{type(e).__name__}: {e}"[:300]
            rows.append(row)
            with open(JSONL, "a") as f:
                f.write(json.dumps(row) + "\n")
            print(
                f"[{time.time() - t_start:7.1f}s] {name} seed {seed}: "
                + (row.get("error", "FAILED") if row["failed"]
                   else f"logZ {row['logZ']:+.4f} ndead {row['ndead']}"),
                flush=True,
            )

    summary = {}
    for name, *_ in CONFIGS:
        ok = [r for r in rows if r["config"] == name and not r["failed"]]
        nfail = sum(1 for r in rows if r["config"] == name and r["failed"])
        pulls = [(r["logZ"] - ANALYTIC) / max(r["logZerr"], 1e-9) for r in ok]
        biases = [r["logZ"] - ANALYTIC for r in ok]
        n = max(len(pulls), 1)
        mean = sum(pulls) / n
        sd = math.sqrt(sum((p - mean) ** 2 for p in pulls) / max(n - 1, 1))
        mean_b = sum(biases) / n
        sd_b = math.sqrt(
            sum((b - mean_b) ** 2 for b in biases) / max(n - 1, 1)
        )
        summary[name] = {
            "n": len(pulls),
            "n_failed": nfail,
            "mean_pull": round(mean, 3),
            "pull_sigma": round(sd, 3),
            "sigma_of_mean": round(sd / math.sqrt(n), 3),
            "mean_logZ_bias": round(mean_b, 4),
            "logZ_bias_sigma_of_mean": round(sd_b / math.sqrt(n), 4),
            "mean_ndead": round(
                sum(r["ndead"] for r in ok) / max(len(ok), 1), 0
            ),
        }
        print(name, json.dumps(summary[name]), flush=True)

    engines = sorted({str(r.get("engine")) for r in rows if not r["failed"]})
    with open(OUT, "w") as f:
        json.dump(
            {
                "analytic_logZ": ANALYTIC,
                "n_seeds": N_SEEDS,
                "platform": platform,
                "engines": engines,
                "git_rev": rev,
                "wall_seconds": round(time.time() - t_start, 1),
                "results": rows,
                "summary": summary,
            },
            f,
            indent=1,
        )


if __name__ == "__main__":
    main()
