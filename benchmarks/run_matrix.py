"""Fill the BASELINE.md measurement matrix: accuracy + throughput per config.

Runs the reference's benchmark problems end-to-end on one GPU and emits one
JSON line per row plus ``benchmarks/results_<platform>.json``.  Every row
names the device it ran on; a device that is not a GPU is an error.
Configs mirror the reference's ini files (``/root/reference/ini/*.ini``
settings, models re-implemented in ``polychordlite_tpu.models``):

    quickstart   4-D gaussian,  nlive=200 (quickstart.py:56, CI workload)
    gaussian20   20-D gaussian, nlive=500, num_repeats=40 (ini/gaussian.ini)
    shells       2-D gaussian_shells, clustering on (ini/gaussian_shells.ini)
    rastrigin    2-D rastrigin, clustering on (ini/rastrigin.ini)
    eggbox       2-D eggbox, clustering on (ini/eggbox.ini)
    rosenbrock   20-D rosenbrock, capped at max_ndead (scaling probe)

Usage: python benchmarks/run_matrix.py [row ...]  (default: all rows)
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))
CHAINS = os.path.join(REPO, "chains", "bench_matrix")


def _box_prior(lo, hi):
    from polychordlite_tpu.priors import UniformPrior

    return UniformPrior(lo, hi)


def _run(name, model_name, n_dims, analytic_logZ, out_list, where,
         prior=None, **kwargs):
    import polychordlite_tpu
    from polychordlite_tpu.models import get_likelihood

    like = get_likelihood(model_name, n_dims)

    def loglikelihood(theta):
        out = like(theta)
        return (out, []) if not isinstance(out, tuple) else (out[0], [])

    defaults = dict(
        nDerived=0,
        nlive=25 * n_dims,
        read_resume=False,
        write_resume=False,
        base_dir=CHAINS,
        file_root=name,
        seed=7,
        feedback=0,
    )
    if prior is not None:
        defaults["prior"] = _box_prior(*prior)
    defaults.update(kwargs)
    # warm-up with identical shapes: the timed run then measures the
    # sampler, not XLA compilation (the reference Fortran has no compile
    # step to pay; executables are reused via the persistent cache)
    warm = dict(defaults)
    warm["file_root"] = name + "_warm"
    warm["max_ndead"] = 300
    polychordlite_tpu.run(loglikelihood, n_dims, **warm)
    t0 = time.time()
    out = polychordlite_tpu.run(loglikelihood, n_dims, **defaults)
    wall = time.time() - t0
    row = {
        "config": name,
        "n_dims": n_dims,
        **where,
        "date": time.strftime("%Y-%m-%d"),
        "nlive": defaults["nlive"],
        "logZ": round(out.logZ, 4),
        "logZerr": round(out.logZerr, 4),
        "analytic_logZ": None if analytic_logZ is None else round(analytic_logZ, 4),
        "logZ_err_sigmas": (
            None
            if analytic_logZ is None
            else round(abs(out.logZ - analytic_logZ) / max(out.logZerr, 1e-9), 2)
        ),
        "ncluster": getattr(out, "ncluster", None),
        "ndead": out.ndead,
        "nlike": out.nlike,
        "wall_s": wall,
        "dead_per_s": out.ndead / wall,
        "evals_per_s": out.nlike / wall,
        # full provenance: the non-default settings this row ran with
        "settings": {
            k: v for k, v in defaults.items()
            if k not in ("prior", "base_dir", "file_root")
        },
    }
    # host attribution from the metrics stream
    recs = [
        json.loads(line)
        for line in open(os.path.join(CHAINS, f"{name}.metrics.jsonl"))
    ]
    host_s = sum(sum(r.get("host_breakdown", {}).values()) for r in recs)
    row["device_frac"] = recs[-1]["device_frac"]
    row["host_ms_per_dead"] = 1e3 * host_s / max(out.ndead, 1)
    row["engine"] = recs[-1].get("engine")
    row["epoch_timers"] = recs[-1].get("epoch_timers")
    print(json.dumps(row), flush=True)
    out_list.append(row)
    return row


ROWS = {
    # name: (model, n_dims, analytic logZ, kwargs incl. the reference ini prior)
    "quickstart": ("gaussian", 4, 0.0, dict(nlive=200)),
    "gaussian20": (
        "gaussian",
        20,
        0.0,  # normalised gaussian over the unit cube (ini/gaussian.ini prior)
        dict(nlive=500, num_repeats=40, do_clustering=False, batch_size=512),
    ),
    "shells": (
        "gaussian_shells",
        2,
        -math.log(12.0 * 5.0),  # normalised over prior box [-6,6]x[-2.5,2.5]
        dict(
            nlive=500,
            do_clustering=True,
            prior=([-6.0, -2.5], [6.0, 2.5]),
        ),
    ),
    "rastrigin": (
        "rastrigin",
        2,
        None,
        dict(
            nlive=500,
            do_clustering=True,
            prior=([-5.12, -5.12], [5.12, 5.12]),  # ini/rastrigin.ini
        ),
    ),
    "eggbox": (
        "eggbox",
        2,
        None,
        dict(
            nlive=500,
            do_clustering=True,
            prior=([0.0, 0.0], [31.4159, 31.4159]),  # ini/eggbox.ini
        ),
    ),
    "rosenbrock": (
        "rosenbrock",
        20,
        None,
        dict(nlive=500, max_ndead=3000, do_clustering=False),
    ),
}
FAST = ["quickstart", "gaussian20", "shells", "rastrigin", "eggbox", "rosenbrock"]


def main():
    from bench import device_fields
    from polychordlite_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    where = device_fields()
    names = sys.argv[1:] or FAST
    platform = where["platform"]
    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), f"results_{platform}.json"
    )

    def save(row):  # incremental merge: a killed run keeps finished rows
        merged = {}
        if os.path.exists(path):
            try:
                for r in json.load(open(path)).get("rows", []):
                    merged[r["config"]] = r
            except Exception:
                pass
        merged[row["config"]] = row
        with open(path, "w") as f:
            json.dump(
                {"platform": platform, "rows": list(merged.values())}, f, indent=1
            )

    results = []
    for name in names:
        model, nd, lz, kw = ROWS[name]
        try:
            save(_run(name, model, nd, lz, results, where, **kw))
        except Exception as e:  # keep filling the matrix
            print(json.dumps({"config": name, "error": repr(e)[:200]}), flush=True)
    print(f"wrote {path}", flush=True)


if __name__ == "__main__":
    main()
