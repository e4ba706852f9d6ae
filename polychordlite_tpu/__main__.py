"""Ini-file CLI driver: ``python -m polychordlite_tpu ini/gaussian.ini``.

Equivalent of the reference's compiled ini drivers
(``src/drivers/polychord_examples.f90`` -> ``run_polychord_ini``,
``interfaces.F90:232-276``): parse the ini, build the block priors and grade
layout, pick the example likelihood (by ``--likelihood`` or the file_root
name), and run.
"""

from __future__ import annotations

import argparse
import sys

from .inidriver import run_ini
from .models import LIKELIHOODS
from .utils.compile_cache import enable_compile_cache


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="polychordlite_tpu",
        description="nested sampling on JAX/XLA (PolyChordLite-compatible)",
    )
    ap.add_argument("inifile", help="ini configuration file")
    ap.add_argument(
        "--likelihood",
        default=None,
        help="example likelihood name (default: inferred from file_root); "
        f"available: {', '.join(sorted(LIKELIHOODS))}",
    )
    args = ap.parse_args(argv)
    enable_compile_cache()

    try:
        out = run_ini(args.inifile, likelihood_name=args.likelihood)
    except ValueError as e:
        ap.error(str(e))
    print(
        "logZ = %.6f +/- %.6f | ndead = %d | nlike = %d"
        % (out["logZ"], out["logZerr"], out["ndead"], out["nlike"])
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
