"""Multi-process strong-scaling proxy for the epoch phase (reference bar:
MPI scaling documented up to O(nlive) cores, ``README.rst:371-377`` of the
reference).

This is a CPU-only proxy: every worker process runs JAX on the CPU backend,
and the parent process never imports JAX.  It was built for a host with 2
physical cores, so the honest proxy is: fixed global chain batch B, P ∈ {1, 2} ``jax.distributed`` processes each PINNED TO ONE CORE
(taskset), one virtual CPU device per process, epoch time measured by the
K-epoch slope (excludes compile + fixed dispatch overhead).  Strong-scaling
efficiency = T(P=1) / (P · T(P)).  P > 2 cannot be measured without
oversubscription lies and is NOT reported as efficiency; instead the
P-dependent cost term — the per-epoch ``process_allgather`` of the nursery
— is measured separately (comm_s) so the transfer-bound regime is
quantified: T(P) ≈ T_compute(B/P) + T_allgather(B), with the allgather
payload independent of P (every process receives the full nursery for
redundant-deterministic administration, SURVEY §5.8).

Writes ``benchmarks/scaling_study.json`` and prints the table.

Usage: python benchmarks/scaling_study.py
"""

import json
import math
import os
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys, json, time
proc_id, n_proc, port, B_global, K = (
    int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], int(sys.argv[4]),
    int(sys.argv[5]))
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=1").strip()
import jax
jax.config.update("jax_platforms", "cpu")
if n_proc > 1:
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}", num_processes=n_proc,
        process_id=proc_id)
sys.path.insert(0, %(repo)r)
import numpy as np
import jax.numpy as jnp
from polychordlite_tpu.ops.evaluate import make_batched_calculator
from polychordlite_tpu.ops.slice_kernel import EpochConfig
from polychordlite_tpu.parallel.mesh import make_epoch_runner

D, R = int(sys.argv[6]), int(sys.argv[7])
def lik(theta):
    return -jnp.sum((theta - 0.5) ** 2) * 60.0

calc = make_batched_calculator(lambda c: c, lik, D, n_derived=1)
cfg = EpochConfig(n_dims=D, n_phi=calc.n_phi, grade_dims=(D,),
                  num_repeats=(R,))
run, B = make_epoch_runner(calc, cfg, batch_size=B_global)
assert B == B_global, (B, B_global)

key = jax.random.PRNGKey(0)
seeds = np.full((B, D), 0.5)
bound = np.full((B,), -2.0)
chol = np.broadcast_to(0.08 * np.eye(D), (B, D, D))

run(key, seeds, bound, chol)  # compile + warm
t0 = time.time()
run(key, seeds, bound, chol)  # 1 epoch (dispatch+collect, warm)
t1 = time.time()
for k in range(K):
    run(jax.random.fold_in(key, k), seeds, bound, chol)
t2 = time.time()
per_epoch = (t2 - t1) / K
print("RESULT " + json.dumps({
    "proc": proc_id, "n_proc": n_proc, "B": B, "K": K,
    "per_epoch_s": per_epoch, "first_warm_epoch_s": t1 - t0}), flush=True)
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def run_config(script, n_proc, B, K=12, D=8, R=16):
    port = free_port()
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["XLA_FLAGS"] = ""
    procs = []
    for i in range(n_proc):
        cmd = [
            "taskset", "-c", str(i % os.cpu_count()),
            sys.executable, script, str(i), str(n_proc), port, str(B),
            str(K), str(D), str(R),
        ]
        procs.append(
            subprocess.Popen(
                cmd, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True,
            )
        )
    rows = []
    for p in procs:
        so, se = p.communicate(timeout=900)
        if p.returncode != 0:
            raise RuntimeError(se[-2000:])
        for line in so.splitlines():
            if line.startswith("RESULT "):
                rows.append(json.loads(line[len("RESULT "):]))
    # the epoch completes when the slowest process has its full nursery
    return max(r["per_epoch_s"] for r in rows), rows


def main():
    import tempfile

    script = os.path.join(tempfile.gettempdir(), "scaling_worker.py")
    with open(script, "w") as f:
        f.write(WORKER % {"repo": REPO})

    out = {"host_cores": os.cpu_count(), "workloads": {}}
    # two workload scales: "small" (quickstart-like epoch, ms-scale — the
    # transfer-bound regime on a TCP-loopback mesh) and "large" (a
    # production-geometry epoch where per-shard compute dominates — the
    # regime real multi-host deployments of slow likelihoods live in)
    for name, (B, D, R, K) in {
        "small": (512, 8, 16, 12),
        "large": (1024, 16, 48, 6),
    }.items():
        results = {}
        rows_all = []
        for n_proc in (1, 2):
            per_epoch, rows = run_config(script, n_proc, B, K=K, D=D, R=R)
            results[n_proc] = per_epoch
            rows_all.append(
                {"n_proc": n_proc, "per_epoch_s": round(per_epoch, 4)}
            )
            print(f"{name} P={n_proc}: {per_epoch * 1e3:.1f} ms/epoch",
                  flush=True)
        eff = results[1] / (2 * results[2])
        out["workloads"][name] = {
            "B": B, "D": D, "R": R, "configs": rows_all,
            "strong_scaling_efficiency_P2": round(eff, 3),
        }
        print(f"{name}: strong-scaling efficiency P=2 = {eff:.1%}",
              flush=True)
    # communication/coordination floor: 2-process epoch at the smallest
    # batch — nearly all of it is allgather + barrier on TCP loopback
    per_epoch_small, _ = run_config(script, 2, 64, K=12)
    out["comm_floor_s_P2_B64"] = round(per_epoch_small, 4)
    print(f"comm floor (P=2, B=64): {per_epoch_small * 1e3:.1f} ms",
          flush=True)
    try:
        rev = subprocess.run(
            ["git", "-C", REPO, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip()
        out["git_rev"] = rev
    except Exception:
        pass
    with open(os.path.join(REPO, "benchmarks", "scaling_study.json"), "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
