"""Run-precision selection — the f64 escape hatch.

The reference computes in f64 throughout (``dp`` kind,
``src/polychord/utils.F90:6``).  The device engines default to f32 —
harmless for likelihoods with |logL| up to ~1e6, but a big-data likelihood
with |logL| ~ 1e7 loses the contour test ``logL >= bound`` in the f32
mantissa (ulp(1e7) = 1).

``precision="highest"`` on the settings/run() surface switches the slice
engine (on any backend) to f64: x64 mode is enabled with the THREAD-LOCAL
``jax.enable_x64`` context for the duration of the run, and every cast in
the evaluate/directions/scan path resolves through :func:`real_dtype`
(also thread-local) — so a default-precision run on another thread of the
same process is unaffected.  Runs in f32 mode warn when the generation
phase sees |logL| beyond ``F32_SAFE_LOGL``.
"""

from __future__ import annotations

import threading

import jax.numpy as jnp

# |logL| beyond which the f32 contour comparison starts losing shells
# (ulp(1e6) ~ 0.06: comparable to a tight contour's shell spacing)
F32_SAFE_LOGL = 1e6

_STATE = threading.local()


def set_real_dtype(dtype) -> None:
    _STATE.dtype = dtype


def real_dtype():
    """The floating dtype of the evaluate/directions/scan-engine path
    (per-thread; default f32)."""
    return getattr(_STATE, "dtype", jnp.float32)
