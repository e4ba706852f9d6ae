"""Repeated-seed pull study on the 20-D normalised Gaussian oracle.

A single-run 20-D check once landed at 2.06 sigma; this decides whether
such a pull is MC noise or a systematic offset.  Runs the same oracle over
N seeds and reports the mean pull (bias) and pull sigma (calibration of the
reported logZerr).  Analytic logZ = 0 for the normalised Gaussian whose mass
lies inside the unit hypercube (reference likelihoods/examples/gaussian.f90).
"""

import json
import math
import sys
import time

import jax.numpy as jnp

import polychordlite_tpu
from polychordlite_tpu.priors import UniformPrior

N_SEEDS = int(sys.argv[1]) if len(sys.argv) > 1 else 10
N_DIMS = 20
SIGMA = 0.01  # mass well inside [0,1]^20 under the unit-cube prior => logZ=0


def likelihood(theta):
    r2 = jnp.sum((theta - 0.5) ** 2)
    return (
        -r2 / (2 * SIGMA**2) - N_DIMS * math.log(SIGMA * math.sqrt(2 * math.pi)),
        [r2],
    )


pulls, rows = [], []
for seed in range(N_SEEDS):
    t0 = time.time()
    out = polychordlite_tpu.run(
        likelihood,
        N_DIMS,
        nDerived=1,
        prior=UniformPrior(0.0, 1.0),
        nlive=200,
        num_repeats=2 * N_DIMS,
        read_resume=False,
        write_resume=False,
        base_dir="/tmp/seed_study",
        file_root="s%d" % seed,
        seed=seed + 1,
        feedback=-1,
    )
    pull = out.logZ / max(out.logZerr, 1e-9)
    pulls.append(pull)
    rows.append(
        {
            "seed": seed + 1,
            "logZ": round(out.logZ, 4),
            "logZerr": round(out.logZerr, 4),
            "pull": round(pull, 3),
            "ndead": out.ndead,
            "wall_s": round(time.time() - t0, 1),
        }
    )
    print(json.dumps(rows[-1]), flush=True)

mean = sum(pulls) / len(pulls)
var = sum((p - mean) ** 2 for p in pulls) / max(len(pulls) - 1, 1)
summary = {
    "n_seeds": N_SEEDS,
    "mean_pull": round(mean, 3),
    "pull_sigma": round(math.sqrt(var), 3),
    "mean_pull_sigma_of_mean": round(mean / (math.sqrt(var / len(pulls)) or 1), 2),
}
print(json.dumps(summary))
with open("benchmarks/seed_study.json", "w") as f:
    json.dump({"rows": rows, "summary": summary}, f, indent=1)
