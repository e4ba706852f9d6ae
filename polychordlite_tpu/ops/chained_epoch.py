"""Chained device epochs with an on-device live-set consume loop ("turbo").

Every dispatch pays a fixed host<->device round trip.  In synchronous mode
that latency cannot be overlapped — the next epoch's seeds depend on the
consumed state — so the only cure is FEWER round trips: run K epochs in
ONE jitted call, with the device itself evolving the live set between
epochs:

    for k in 1..K:                 (lax.scan)
        bound   = min(live_logL)                 # the rising contour
        seeds   = live_cube[randint(nlive, B)]   # uniform live picks
        babies  = slice_engine(seeds, bound, cholesky)   # existing kernel
        for i in 1..B:             (lax.scan — sequential, exact order)
            if baby_logL[i] > min(live_logL):
                live[argmin(live_logL)] = baby[i]        # delete + insert

This is EXACTLY the synchronous algorithm (one nursery per contour state,
seeds current at dispatch — the mode the 64-seed calibration measures as
unbiased), just executed device-side; the host then REPLAYS the identical
decisions from the fetched records through the ordinary bookkeeping
(evidence recurrences, phantoms, posteriors, files), so the evidence
arithmetic is bit-for-bit the usual path.  After the replay the host
live-set logL multiset is asserted equal to the device's final state —
any divergence (a float tie-break, an unmodelled rule) disables the
chained path loudly for the rest of the run.

Documented deviations while a chain is in flight (all statistics-neutral):
* the whitening cholesky is frozen for up to K e-folds (slice sampling is
  exact under ANY fixed full-rank whitening; only mixing efficiency moves);
* cluster splits detected during the replay discard the not-yet-consumed
  remainder of the chain (the device evolved a one-cluster state);
* host-side seed RNG is not consumed (stream change, like an engine
  switch).

Gating (core/nested_sampling.py): synchronous single-device runs with one
cluster, no nlives schedule, full nursery batch, traced likelihood.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from .precision import real_dtype
from .slice_kernel import EpochConfig, build_epoch_fn


def build_chained_fn(
    calc,
    cfg: EpochConfig,
    B_log: int,
    K: int,
    nlive: int,
):
    """Build the jitted K-epoch chain.

    Transfer discipline (one transfer each way per chain):

    * upload: ONE f32 blob per chain = [key as 4 exact-integer half-words
      (bit-exact: each half-word <= 65535 is exactly representable in f32 —
      a raw bitcast could hit NaN payloads that transfers may
      canonicalize), chol (D*D), live_cube (nlive*D), live_logL (nlive)];
    * fetch: ONE flat f32 buffer = [packs | bounds | final_live_logL].

    ``fn(blob) -> flat`` where ``flat`` = ``K*B_log*W + K + nlive`` floats,
    W = R*(stride-D) + tail (the COMPACT record layout: theta columns
    dropped on device, re-derived host-side by ``calc.theta_batch_host``).

    Sequential-consume correctness: replace-min with babies processed in
    order maintains the invariant that the live set equals the nlive
    largest of {initial live} ∪ {babies so far} (pop-min-push beats the
    (nlive+1)-th largest by induction), so the final state is a single
    ``top_k`` over the concatenation — no O(B) sequential scan on device.
    The host replay still processes babies one-by-one through the exact
    evidence recurrences; only the device's *state evolution* uses the
    closed form.
    """
    if cfg.engine == "ring":
        # the ring engine's overflow-rerun protocol has no chain analogue
        raise ValueError("chained epochs do not support the ring engine")
    D = cfg.n_dims
    R = cfg.total_repeats
    stride = 2 * D + cfg.n_phi + 1
    raw = build_epoch_fn(calc, cfg, axis_name=None)

    @jax.jit
    def fn(blob):
        dt = real_dtype()
        hw = blob[:4].astype(jnp.uint32)  # [k0_hi, k0_lo, k1_hi, k1_lo]
        key = jnp.stack(
            [hw[0] * 65536 + hw[1], hw[2] * 65536 + hw[3]]
        ).astype(jnp.uint32)
        o = 4
        chol = blob[o : o + D * D].astype(dt).reshape(D, D)
        o += D * D
        live_cube = blob[o : o + nlive * D].astype(dt).reshape(nlive, D)
        o += nlive * D
        live_logL = blob[o : o + nlive].astype(dt)
        chol_b = jnp.broadcast_to(chol, (B_log, D, D))
        valid = jnp.ones((B_log,), bool)

        def epoch_body(carry, k):
            lc, ll = carry
            ekey = jax.random.fold_in(key, k)
            bound0 = ll.min()
            idx = jax.random.randint(
                jax.random.fold_in(ekey, 0x5EED5), (B_log,), 0, nlive
            )
            seeds = lc[idx]
            bound = jnp.full((B_log,), bound0, dt)
            packed = raw(ekey, seeds, bound, chol_b, valid)
            rec = packed[:, : R * stride].reshape(B_log, R, stride)
            bcube = rec[:, -1, :D]
            blogL = rec[:, -1, -1]

            # replace-min over the whole nursery == top-nlive of the union
            all_logL = jnp.concatenate([ll, blogL])
            all_cube = jnp.concatenate([lc, bcube], axis=0)
            top_logL, top_idx = jax.lax.top_k(all_logL, nlive)
            lc = all_cube[top_idx]
            ll = top_logL

            # compact fetch layout: drop the theta columns (mesh.expand
            # re-derives them host-side from the cube)
            crec = jnp.concatenate(
                [rec[:, :, :D], rec[:, :, 2 * D :]], axis=2
            ).reshape(B_log, R * (stride - D))
            cpacked = jnp.concatenate(
                [crec, packed[:, R * stride :]], axis=1
            )
            return (lc, ll), (cpacked, bound0)

        (lc, ll), (packs, bounds) = jax.lax.scan(
            epoch_body, (live_cube, live_logL), jnp.arange(K)
        )
        return jnp.concatenate(
            [packs.reshape(-1), bounds.astype(dt), ll]
        )

    return fn


def pack_chain_blob(key, chol, live_cube, live_logL) -> "np.ndarray":
    """Host-side: the single per-chain upload buffer (see fn docstring)."""
    import numpy as np

    k = np.asarray(key, dtype=np.uint32)
    hw = np.array(
        [k[0] >> 16, k[0] & 0xFFFF, k[1] >> 16, k[1] & 0xFFFF],
        dtype=np.float32,
    )
    return np.concatenate(
        [
            hw,
            np.asarray(chol, dtype=np.float32).ravel(),
            np.asarray(live_cube, dtype=np.float32).ravel(),
            np.asarray(live_logL, dtype=np.float32).ravel(),
        ]
    ).astype(np.float32)
