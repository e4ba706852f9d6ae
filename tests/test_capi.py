"""C ABI round-trip: compile a C driver against csrc/capi.{c,h} and run a
2-D gaussian through ``polychord_c_interface`` — the analogue of the
reference's C++ driver path (src/drivers/polychord_CC.cpp ->
interfaces.h -> interfaces.F90:285)."""

import json
import math
import os
import shutil
import subprocess
import sys
import sysconfig

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

pytestmark = [
    pytest.mark.skipif(shutil.which("gcc") is None, reason="no C toolchain"),
    pytest.mark.slow,  # multi-minute e2e lane (make test-fast skips)
]

DRIVER = r"""
#include <math.h>
#include <stdio.h>
#include <string.h>
#include "capi.h"

/* 2-D normalised gaussian at 0.5, sigma 0.1 */
static double loglike(double *theta, int nDims, double *phi, int nDerived) {
    double r2 = 0.0;
    for (int i = 0; i < nDims; i++) {
        double d = theta[i] - 0.5;
        r2 += d * d;
    }
    if (nDerived > 0) phi[0] = sqrt(r2);
    return -r2 / (2 * 0.01) - nDims * log(0.1 * sqrt(2 * M_PI));
}

static void prior(double *cube, double *theta, int nDims) {
    for (int i = 0; i < nDims; i++) theta[i] = cube[i]; /* unit cube */
}

static int dumper_calls = 0;
static double last_logZ = 1e30;
static void dumper(int ndead, int nlive, int npars, double *live,
                   double *dead, double *logweights, double logZ,
                   double logZerr) {
    (void)live; (void)dead; (void)logweights; (void)logZerr;
    (void)ndead; (void)nlive; (void)npars;
    dumper_calls++;
    last_logZ = logZ;
}

int main(int argc, char **argv) {
    char base_dir[256], file_root[16] = "capi";
    strncpy(base_dir, argv[1], 255);
    double grade_frac[1] = {1.0};
    int grade_dims[1] = {2};
    int comm = 0;
    polychord_c_interface(
        loglike, prior, dumper,
        /*nlive*/ 60, /*num_repeats*/ 4, /*nprior*/ -1, /*nfail*/ -1,
        /*do_clustering*/ false, /*feedback*/ 0,
        /*precision_criterion*/ 0.01, /*logzero*/ -1e30, /*max_ndead*/ -1,
        /*boost_posterior*/ 0.0, /*posteriors*/ true, /*equals*/ true,
        /*cluster_posteriors*/ false, /*write_resume*/ false,
        /*write_paramnames*/ false, /*read_resume*/ false,
        /*write_stats*/ true, /*write_live*/ false, /*write_dead*/ true,
        /*write_prior*/ false, /*maximise*/ false,
        /*compression_factor*/ 0.36787944117144233, /*synchronous*/ true,
        /*nDims*/ 2, /*nDerived*/ 1, base_dir, file_root,
        /*nGrade*/ 1, grade_frac, grade_dims,
        /*n_nlives*/ 0, NULL, NULL, /*seed*/ 3, &comm);
    printf("DUMPER_CALLS %d LAST_LOGZ %.6f\n", dumper_calls, last_logZ);
    return 0;
}
"""


def test_c_interface_end_to_end(tmp_path):
    build = tmp_path / "build"
    build.mkdir()
    driver_c = build / "driver.c"
    driver_c.write_text(DRIVER)

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    exe = str(build / "driver")
    cmd = [
        "gcc", "-O1", "-o", exe,
        str(driver_c), os.path.join(REPO, "csrc", "capi.c"),
        f"-I{inc}", f"-I{os.path.join(REPO, 'csrc')}",
        f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{pyver}", "-lm", "-ldl",
    ]
    subprocess.run(cmd, check=True, capture_output=True, timeout=120)

    chains = tmp_path / "chains"
    (chains / "clusters").mkdir(parents=True)
    env = dict(os.environ)
    # the embedded interpreter is the base python: reach the venv's packages
    # and the repo through PYTHONPATH, and force the CPU backend (a C
    # callback likelihood is host code)
    site = sysconfig.get_paths()["purelib"]
    venv_site = [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = ":".join([REPO] + venv_site + [site])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [exe, str(chains)],
        capture_output=True,
        text=True,
        timeout=600,
        env=env,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    line = [l for l in out.stdout.splitlines() if l.startswith("DUMPER_CALLS")]
    assert line, out.stdout[-2000:]
    ncalls, logZ = int(line[0].split()[1]), float(line[0].split()[3])
    assert ncalls >= 2

    # stats file written and parseable; logZ near analytic 0.0
    stats = chains / "capi.stats"
    assert stats.exists()
    from polychordlite_tpu.output import PolyChordOutput

    po = PolyChordOutput(str(chains), "capi")
    assert abs(po.logZ) < 3 * po.logZerr + 0.2
    assert abs(logZ - po.logZ) < 0.5  # dumper saw the same evidence


DRIVER_INI = r"""
#include <math.h>
#include <stdio.h>
#include "capi.h"

static double loglike(double *theta, int nDims, double *phi, int nDerived) {
    (void)phi; (void)nDerived;
    double r2 = 0.0;
    for (int i = 0; i < nDims; i++) {
        double d = theta[i] - 0.5;
        r2 += d * d;
    }
    return -r2 / (2 * 0.01) - nDims * log(0.1 * sqrt(2 * M_PI));
}

static int setup_called = 0;
static void setup(void) { setup_called = 1; }

int main(int argc, char **argv) {
    int comm = 0;
    polychord_c_interface_ini(loglike, setup, argv[1], &comm);
    printf("SETUP %d\n", setup_called);
    return 0;
}
"""

INI = """
[ algorithm settings ]
nlive = 50
num_repeats = 4
do_clustering = F
precision_criterion = 0.01
[ output settings ]
base_dir = %(base)s
file_root = capini
write_resume = F
read_resume = F
feedback = 0
seed = 4
max_ndead = 400
[ prior settings ]
P : p1 | \\theta_{1} | 1 | uniform | 1 | 0.0 1.0
P : p2 | \\theta_{2} | 1 | uniform | 1 | 0.0 1.0
"""


def test_c_interface_ini(tmp_path):
    build = tmp_path / "build"
    build.mkdir()
    (build / "driver.c").write_text(DRIVER_INI)
    chains = tmp_path / "chains"
    (chains / "clusters").mkdir(parents=True)
    ini = tmp_path / "run.ini"
    ini.write_text(INI % {"base": chains})

    inc = sysconfig.get_paths()["include"]
    libdir = sysconfig.get_config_var("LIBDIR")
    pyver = f"python{sys.version_info.major}.{sys.version_info.minor}"
    exe = str(build / "driver")
    subprocess.run(
        [
            "gcc", "-O1", "-o", exe,
            str(build / "driver.c"), os.path.join(REPO, "csrc", "capi.c"),
            f"-I{inc}", f"-I{os.path.join(REPO, 'csrc')}",
            f"-L{libdir}", f"-Wl,-rpath,{libdir}", f"-l{pyver}", "-lm", "-ldl",
        ],
        check=True, capture_output=True, timeout=120,
    )
    env = dict(os.environ)
    site = sysconfig.get_paths()["purelib"]
    venv_site = [p for p in sys.path if p.endswith("site-packages")]
    env["PYTHONPATH"] = ":".join([REPO] + venv_site + [site])
    env["JAX_PLATFORMS"] = "cpu"
    out = subprocess.run(
        [exe, str(ini)], capture_output=True, text=True, timeout=600, env=env
    )
    assert out.returncode == 0, out.stderr[-2000:]
    assert "SETUP 1" in out.stdout
    assert (chains / "capini.stats").exists()


def test_comm_shim_overloads_compile(tmp_path):
    """Source-compat: the reference's USE_MPI overload set
    (interfaces.hpp:67-88, trailing `MPI_Comm &comm`) must compile
    zero-diff against BOTH MPI_Comm styles — pointer typedefs (OpenMPI)
    and integer typedefs (MPICH) — via the template shims in
    csrc/polychord.hpp.  Compile-only (syntax + overload resolution)."""
    src = tmp_path / "comm_shim.cpp"
    src.write_text(
        r"""
#include "polychord.hpp"
struct fake_ompi_comm_t {};                 // OpenMPI style: a pointer
typedef fake_ompi_comm_t *PtrComm;
typedef int IntComm;                        // MPICH style: an int
static double lik(double *, int, double *, int) { return 0.0; }
static void pri(double *c, double *t, int n) { for (int i=0;i<n;i++) t[i]=c[i]; }
static void dmp(int, int, int, double *, double *, double *, double, double) {}
static void setup() {}
template <typename C> void call_all(C &comm) {
    Settings s(2, 0);
    run_polychord(lik, pri, dmp, s, comm);
    run_polychord(lik, dmp, s, comm);
    run_polychord(lik, pri, s, comm);
    run_polychord(lik, s, comm);
    run_polychord(lik, setup, std::string("x.ini"), comm);
}
int main() {
    PtrComm pc = nullptr; IntComm ic = 42;
    if (false) { call_all(pc); call_all(ic); }   // compile-only
    return 0;
}
"""
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    subprocess.run(
        ["g++", "-fsyntax-only", "-I", os.path.join(repo, "csrc"),
         str(src)],
        check=True,
        capture_output=True,
        timeout=120,
    )
