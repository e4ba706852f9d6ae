"""The batched whitened slice-sampling engine — the device hot path.

This replaces the reference's per-process sequential slice chains
(``src/polychord/chordal_sampling.f90:7-273``) and its MPI worker farm
(``src/polychord/nested_sampling.F90:445-498``) with a single jitted
function: B independent chains advance together, and every step of the
inner loop performs ONE batched likelihood evaluation of all B probe
points, so the likelihood always runs as a (B, D) vectorised computation.

Two engines share one contract and produce bitwise-identical output
(tested):

* ``engine="scan"`` — outer ``lax.scan`` over the R slice repeats, inner
  masked ``lax.while_loop`` per repeat.  Every repeat waits for the slowest
  of B lanes.  This is the default engine.
* ``engine="ring"`` — ONE persistent ``lax.while_loop``; each lane advances
  through its own R repeats independently, so the tail sync happens once per
  epoch instead of once per repeat.  Per-lane output scatters are avoided
  by construction:
    - accepted babies are appended to an iteration-indexed ring buffer
      (scalar-index ``dynamic_update_slice``, never a per-lane scatter),
      with the repeat index recorded as a per-slot sort key;
    - ONE post-loop per-lane integer sort of (repeat, slot) pairs plus ONE
      batched row gather reorders the ring into repeat order;
    - theta/phi are re-derived from the accepted cubes in one batched
      post-loop evaluation (not counted in nlike) instead of being carried
      through the loop.
  If a pathological epoch exhausts the ring (> ring_factor iterations per
  repeat on the slowest lane), the engine raises an overflow flag and the
  runner re-runs the epoch with the scan engine — results stay identical.
  The ring engine trades fewer loop trips for per-lane dynamically indexed
  memory operations (the direction gather and the sort-key write).

Per-lane state machine for one repeat (Neal 2003, mirroring ``slice_sample``
chordal_sampling.f90:163-273):

    INIT_R  draw u, set the random interval [x0-u*w, x0+(1-u)*w], evaluate
            its right end
    INIT_L  evaluate left end
    STEP_R  expand right bound in unit-w steps while inside the contour
    STEP_L  expand left bound likewise
    SHRINK  draw uniformly in (tL, tR); accept if inside, else contract the
            side the draw fell on; after ``max_shrink`` failures the point
            is returned with logL = logzero ("non-deterministic
            loglikelihood" guard, chordal_sampling.f90:268-271)
    DONE    lane finished all its work

Because each chain's chord is parameterised by the scalar coordinate t
(probe = x0 + t*n̂, |n̂| = 1), the slice bounds are two scalars per lane.

Randomness is counter-based per (lane, repeat, iteration-within-repeat):
u = uniform(fold_in(fold_in(fold_in(epoch_key, 2*lane+1), repeat), it)).
The INIT_R iteration's draw (it=0) doubles as the initial-interval position.
Draws never depend on when other lanes converge, which is what makes the two
engines bitwise-identical and the results independent of how the chain batch
is sharded across devices.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from .directions import make_directions
from .logspace import LOG_ZERO
from .precision import real_dtype

# Phases of the per-lane state machine.
PH_INIT_R = 0
PH_INIT_L = 1
PH_STEP_R = 2
PH_STEP_L = 3
PH_SHRINK = 4
PH_DONE = 5

#: the slice engines :func:`build_epoch_fn` can build
ENGINES = ("scan", "ring")


class EpochConfig(NamedTuple):
    """Static configuration of the slice engine (shapes are compile-time)."""

    n_dims: int
    n_phi: int
    grade_dims: Tuple[int, ...]
    num_repeats: Tuple[int, ...]
    logzero: float = LOG_ZERO
    max_step: int = 200   # stepping-out cap (reference warns past 100 and has no cap)
    max_shrink: int = 100  # shrinkage cap (chordal_sampling.f90:240-271)
    engine: str = "scan"   # "scan" (per-repeat, default) or "ring" (fused per-lane)
    ring_factor: int = 12  # ring engine: ring slots per repeat before overflow

    @property
    def total_repeats(self) -> int:
        return int(sum(self.num_repeats))


def _lane_keys(key, B, axis_name):
    """Per-lane direction/loop keys from *global* lane indices (shard-safe)."""
    if axis_name is not None:
        offset = jax.lax.axis_index(axis_name) * B
    else:
        offset = 0
    lane_ids = offset + jnp.arange(B)
    dir_keys = jax.vmap(lambda i: jax.random.fold_in(key, 2 * i))(lane_ids)
    loop_keys = jax.vmap(lambda i: jax.random.fold_in(key, 2 * i + 1))(lane_ids)
    return dir_keys, loop_keys


def _mark_vma(state, axis_name):
    """Inside shard_map, mark loop carries as varying over the chains axis."""
    if axis_name is None:
        return state

    def _mark(v):
        if axis_name in jax.typeof(v).vma:
            return v
        return jax.lax.pcast(v, (axis_name,), to="varying")

    return jax.tree.map(_mark, state)


def build_epoch_fn(calc_point_batch, cfg: EpochConfig, axis_name: Optional[str] = None):
    """Build the jittable epoch function for ``cfg.engine``.

    ``epoch(key, seed_cube, bound, cholesky, lane_valid)`` runs one slice
    chain per lane and returns a single packed
    (B, R*(2D+n_phi+1) + n_grades + 1) f32 buffer (see :func:`unpack_epoch`)
    — one device->host transfer per epoch.  The final column is the
    ring-overflow flag for the ring engine, and the number of inner
    ``while_loop`` trips the epoch took for the scan engine.

    ``axis_name`` is set when running inside ``shard_map`` over the chain
    batch; it only affects the *global* lane indices of the per-lane RNG
    streams (no collectives — the epoch is embarrassingly parallel).
    """
    if cfg.engine == "ring":
        return build_epoch_fn_ring(calc_point_batch, cfg, axis_name)
    if cfg.engine == "scan":
        return build_epoch_fn_scan(calc_point_batch, cfg, axis_name)
    raise ValueError(
        f"unknown slice engine {cfg.engine!r}; choose one of {ENGINES}"
    )


def build_epoch_fn_scan(
    calc_point_batch, cfg: EpochConfig, axis_name: Optional[str] = None
):
    """Scan-over-repeats engine (the bitwise oracle for the ring engine, and
    the overflow fallback).

    For decomposed fast/slow likelihoods (models/graded.py) this engine
    exploits the grade structure: the slot shuffle is shared across the
    batch so every repeat is grade-uniform, the slow-part intermediate
    ``aux`` is carried through the scan (recomputed only after slow-grade
    repeats), and fast-grade probes evaluate only ``fast_fn`` — the
    reference's fast/slow win (``generate.F90:330-455``,
    ``chordal_sampling.f90:94-145``) made explicit for a functional
    engine."""
    D = cfg.n_dims
    R = cfg.total_repeats
    n_grades = len(cfg.grade_dims)
    logzero = cfg.logzero
    max_inner = 2 * cfg.max_step + cfg.max_shrink + 4
    graded = bool(getattr(calc_point_batch, "graded", False)) and n_grades > 1

    def epoch(key, seed_cube, bound, cholesky, lane_valid):
        B = seed_cube.shape[0]
        dir_keys, loop_keys = _lane_keys(key, B, axis_name)

        nhats, ws, speeds = make_directions(
            dir_keys,
            cholesky,
            grade_dims=cfg.grade_dims,
            num_repeats=cfg.num_repeats,
            n_dims=D,
            shared_perm_key=jax.random.fold_in(key, 0x5EED),
        )
        bound_f = bound.astype(real_dtype())
        valid = lane_valid

        def one_repeat(carry, per_repeat):
            """One slice sample per lane (slice_sample,
            chordal_sampling.f90:163-273), vectorised over the batch.

            Each lane advances exactly one transition per inner iteration,
            so its k-th iteration index is k regardless of how long OTHER
            lanes' loops run — results are bitwise independent of the
            sharding (threading a split key through the loop would couple
            lanes to the local batch's convergence length)."""
            if graded:
                x0, aux = carry
            else:
                x0 = carry
            nhat, w, grade, r_idx = per_repeat  # (B,D), (B,), (B,), ()
            # shared shuffle in graded mode -> the repeat is grade-uniform
            grade_u = grade[0]

            rep_keys = jax.vmap(lambda k: jax.random.fold_in(k, r_idx))(loop_keys)

            state = dict(
                tL=jnp.zeros((B,), real_dtype()),
                tR=jnp.zeros((B,), real_dtype()),
                rstep=jnp.ones((B,), jnp.int32),
                lstep=jnp.ones((B,), jnp.int32),
                nshrink=jnp.zeros((B,), jnp.int32),
                need_r=jnp.zeros((B,), bool),
                need_l=jnp.zeros((B,), bool),
                phase=jnp.where(valid, PH_INIT_R, PH_DONE).astype(jnp.int32),
                acc_cube=x0,
                acc_theta=jnp.zeros((B, D), real_dtype()),
                acc_phi=jnp.zeros((B, cfg.n_phi), real_dtype()),
                acc_logL=jnp.full((B,), logzero, real_dtype()),
                nlike=jnp.zeros((B,), jnp.int32),
                iters=jnp.zeros((), jnp.int32),
            )
            state = _mark_vma(state, axis_name)

            def cond(st):
                return jnp.any(st["phase"] != PH_DONE) & (st["iters"] < max_inner)

            def body(st):
                phase = st["phase"]
                it = st["iters"]
                u = jax.vmap(
                    lambda k: jax.random.uniform(jax.random.fold_in(k, it), ())
                )(rep_keys)

                is_ir = phase == PH_INIT_R
                # INIT_R consumes its draw as the initial interval position
                tL = jnp.where(is_ir, -u * w, st["tL"])
                tR = jnp.where(is_ir, (1.0 - u) * w, st["tR"])

                # ---- probe position (pre-eval) -------------------------
                t = jnp.where(is_ir, tR, 0.0)
                t = jnp.where(phase == PH_INIT_L, tL, t)
                t = jnp.where(phase == PH_STEP_R, w * st["rstep"], t)
                t = jnp.where(phase == PH_STEP_L, -w * st["lstep"], t)
                t_sh = tL + u * (tR - tL)
                t = jnp.where(phase == PH_SHRINK, t_sh, t)

                probe = x0 + t[:, None] * nhat
                if graded:
                    # slow-grade repeats evaluate the full likelihood; fast
                    # repeats reuse the cached slow intermediate (only the
                    # taken branch executes under lax.cond)
                    theta, phi, logL = jax.lax.cond(
                        grade_u == 0,
                        lambda a, p: calc_point_batch(p),
                        calc_point_batch.fast_point_batch,
                        aux,
                        probe,
                    )
                else:
                    theta, phi, logL = calc_point_batch(probe)

                inside = (logL >= bound_f) & (logL > logzero)
                counted = (phase != PH_DONE) & (logL > logzero)
                nlike = st["nlike"] + counted.astype(jnp.int32)

                is_il = phase == PH_INIT_L
                is_sr = phase == PH_STEP_R
                is_sl = phase == PH_STEP_L
                is_sh = phase == PH_SHRINK

                need_r = jnp.where(is_ir, inside, st["need_r"])
                need_l = jnp.where(is_il, inside, st["need_l"])
                after_init_l = jnp.where(
                    need_r, PH_STEP_R, jnp.where(need_l, PH_STEP_L, PH_SHRINK)
                )

                done_r = is_sr & (~inside | (st["rstep"] >= cfg.max_step))
                done_l = is_sl & (~inside | (st["lstep"] >= cfg.max_step))
                tR = jnp.where(done_r, t, tR)
                tL = jnp.where(done_l, t, tL)
                rstep = jnp.where(is_sr & ~done_r, st["rstep"] + 1, st["rstep"])
                lstep = jnp.where(is_sl & ~done_l, st["lstep"] + 1, st["lstep"])

                accept = is_sh & inside
                forced = is_sh & ~inside & (st["nshrink"] + 1 >= cfg.max_shrink)
                acc = accept | forced
                contract = is_sh & ~inside & ~forced
                tR = jnp.where(contract & (t > 0.0), t, tR)
                tL = jnp.where(contract & (t <= 0.0), t, tL)
                nshrink = jnp.where(
                    contract | forced, st["nshrink"] + 1, st["nshrink"]
                )

                logL_store = jnp.where(forced, logzero, logL)
                acc_cube = jnp.where(acc[:, None], probe, st["acc_cube"])
                acc_theta = jnp.where(acc[:, None], theta, st["acc_theta"])
                acc_phi = jnp.where(acc[:, None], phi, st["acc_phi"])
                acc_logL = jnp.where(acc, logL_store, st["acc_logL"])

                phase = jnp.where(is_ir, PH_INIT_L, phase)
                phase = jnp.where(is_il, after_init_l, phase)
                phase = jnp.where(
                    done_r, jnp.where(need_l, PH_STEP_L, PH_SHRINK), phase
                )
                phase = jnp.where(done_l, PH_SHRINK, phase)
                phase = jnp.where(acc, PH_DONE, phase)

                return dict(
                    tL=tL,
                    tR=tR,
                    rstep=rstep,
                    lstep=lstep,
                    nshrink=nshrink,
                    need_r=need_r,
                    need_l=need_l,
                    phase=phase.astype(jnp.int32),
                    acc_cube=acc_cube,
                    acc_theta=acc_theta,
                    acc_phi=acc_phi,
                    acc_logL=acc_logL,
                    nlike=nlike,
                    iters=st["iters"] + 1,
                )

            st = jax.lax.while_loop(cond, body, state)

            # the accepted baby becomes the next repeat's start point — even a
            # forced logzero accept, as in the reference (the chain continues
            # from the failed probe, SliceSampling chordal_sampling.f90:85-89)
            new_x0 = st["acc_cube"]
            if graded:
                # the slow parameters changed only if this was a slow-grade
                # repeat: refresh the cached intermediate then (one slow
                # evaluation per slow repeat, not per probe)
                new_aux = jax.lax.cond(
                    grade_u == 0,
                    lambda c, a: calc_point_batch.slow_aux_batch(c),
                    lambda c, a: a,
                    new_x0,
                    aux,
                )
            out = jnp.concatenate(
                [
                    st["acc_cube"],
                    st["acc_theta"],
                    st["acc_phi"],
                    st["acc_logL"][:, None],
                ],
                axis=1,
            )  # (B, 2D + n_phi + 1)
            nlike_g = (
                jax.nn.one_hot(grade, n_grades, dtype=jnp.int32)
                * st["nlike"][:, None]
            )  # (B, n_grades)
            carry = (new_x0, new_aux) if graded else new_x0
            return carry, (out, nlike_g, st["iters"])

        per_repeat = (
            jnp.swapaxes(nhats, 0, 1),  # (R, B, D)
            jnp.swapaxes(ws, 0, 1),  # (R, B)
            jnp.swapaxes(speeds, 0, 1),  # (R, B)
            jnp.arange(R),  # repeat indices for the RNG streams
        )
        seed_f = seed_cube.astype(real_dtype())
        init_carry = (
            (seed_f, calc_point_batch.slow_aux_batch(seed_f))
            if graded
            else seed_f
        )
        x_final, (outs, nlike_g, trips) = jax.lax.scan(
            one_repeat, init_carry, per_repeat
        )
        # outs: (R, B, 2D+n_phi+1) -> (B, R*(2D+n_phi+1));
        # nlike_g: (R, B, n_grades) -> (B, n_grades)
        stride = 2 * D + cfg.n_phi + 1
        babies = jnp.swapaxes(outs, 0, 1).reshape(B, R * stride)
        nlike = nlike_g.sum(axis=0)
        packed = jnp.concatenate(
            [
                babies,
                nlike.astype(real_dtype()),
                # loop trips of this device's epoch (the ring engine's
                # overflow-flag column)
                jnp.broadcast_to(trips.sum().astype(real_dtype()), (B, 1)),
            ],
            axis=1,
        )
        return packed

    return epoch


def build_epoch_fn_ring(
    calc_point_batch, cfg: EpochConfig, axis_name: Optional[str] = None
):
    """Fused persistent-lane engine with ring-buffer baby recording.

    See the module docstring for the design; bitwise-identical to
    :func:`build_epoch_fn_scan` (tested) whenever the ring does not
    overflow, and flags overflow otherwise.
    """
    D = cfg.n_dims
    R = cfg.total_repeats
    n_grades = len(cfg.grade_dims)
    logzero = cfg.logzero
    stride = 2 * D + cfg.n_phi + 1
    T_ring = R * cfg.ring_factor + 1  # slot 0 reserved for the default entry
    max_total = T_ring - 1

    def epoch(key, seed_cube, bound, cholesky, lane_valid):
        B = seed_cube.shape[0]
        dir_keys, loop_keys = _lane_keys(key, B, axis_name)

        nhats, ws, speeds = make_directions(
            dir_keys,
            cholesky,
            grade_dims=cfg.grade_dims,
            num_repeats=cfg.num_repeats,
            n_dims=D,
            shared_perm_key=jax.random.fold_in(key, 0x5EED),
        )  # (B,R,D), (B,R), (B,R)

        bound_f = bound.astype(real_dtype())
        x0 = seed_cube.astype(real_dtype())
        valid = lane_valid

        def draw(rep, it):
            return jax.vmap(
                lambda k, r, c: jax.random.uniform(
                    jax.random.fold_in(jax.random.fold_in(k, r), c), ()
                )
            )(loop_keys, rep, it)

        def gather_repeat(rep):
            idx = jnp.minimum(rep, R - 1)
            nhat = jnp.take_along_axis(nhats, idx[:, None, None], axis=1)[:, 0]
            w = jnp.take_along_axis(ws, idx[:, None], axis=1)[:, 0]
            grade = jnp.take_along_axis(speeds, idx[:, None], axis=1)[:, 0]
            return nhat, w, grade

        rep0 = jnp.where(valid, 0, R).astype(jnp.int32)
        nhat0, w0, grade0 = gather_repeat(rep0)

        # ring slot 0 = the never-accepted default entry (seed cube, logzero)
        ring0 = jnp.zeros((B, T_ring, D + 1), real_dtype())
        ring0 = ring0.at[:, 0, :D].set(x0)
        ring0 = ring0.at[:, 0, D].set(logzero)

        state = dict(
            rep=rep0,
            it=jnp.zeros((B,), jnp.int32),
            phase=jnp.where(valid, PH_INIT_R, PH_DONE).astype(jnp.int32),
            tL=jnp.zeros((B,), real_dtype()),
            tR=jnp.zeros((B,), real_dtype()),
            rstep=jnp.ones((B,), jnp.int32),
            lstep=jnp.ones((B,), jnp.int32),
            nshrink=jnp.zeros((B,), jnp.int32),
            need_r=jnp.zeros((B,), bool),
            need_l=jnp.zeros((B,), bool),
            x0=x0,
            nhat=nhat0,
            w=w0,
            grade=grade0,
            ring=ring0,
            # per-slot sort key: the repeat the slot's baby belongs to, or
            # T_ring (sentinel) for non-accepting iterations
            ring_rep=jnp.full((B, T_ring), T_ring, jnp.int32),
            nlike_g=jnp.zeros((B, n_grades), jnp.int32),
            iters=jnp.zeros((), jnp.int32),
        )
        state = _mark_vma(state, axis_name)

        def cond(st):
            return jnp.any(st["phase"] != PH_DONE) & (st["iters"] < max_total)

        def body(st):
            phase = st["phase"]
            w = st["w"]
            u = draw(st["rep"], st["it"])

            is_ir = phase == PH_INIT_R
            tL = jnp.where(is_ir, -u * w, st["tL"])
            tR = jnp.where(is_ir, (1.0 - u) * w, st["tR"])

            t = jnp.where(is_ir, tR, 0.0)
            t = jnp.where(phase == PH_INIT_L, tL, t)
            t = jnp.where(phase == PH_STEP_R, w * st["rstep"], t)
            t = jnp.where(phase == PH_STEP_L, -w * st["lstep"], t)
            t_sh = tL + u * (tR - tL)
            t = jnp.where(phase == PH_SHRINK, t_sh, t)

            probe = st["x0"] + t[:, None] * st["nhat"]
            theta, phi, logL = calc_point_batch(probe)  # theta/phi DCE'd

            inside = (logL >= bound_f) & (logL > logzero)
            engaged = phase != PH_DONE
            counted = engaged & (logL > logzero)
            nlike_g = st["nlike_g"] + (
                jax.nn.one_hot(st["grade"], n_grades, dtype=jnp.int32)
                * counted.astype(jnp.int32)[:, None]
            )

            is_il = phase == PH_INIT_L
            is_sr = phase == PH_STEP_R
            is_sl = phase == PH_STEP_L
            is_sh = phase == PH_SHRINK

            need_r = jnp.where(is_ir, inside, st["need_r"])
            need_l = jnp.where(is_il, inside, st["need_l"])
            after_init_l = jnp.where(
                need_r, PH_STEP_R, jnp.where(need_l, PH_STEP_L, PH_SHRINK)
            )

            done_r = is_sr & (~inside | (st["rstep"] >= cfg.max_step))
            done_l = is_sl & (~inside | (st["lstep"] >= cfg.max_step))
            tR = jnp.where(done_r, t, tR)
            tL = jnp.where(done_l, t, tL)
            rstep = jnp.where(is_sr & ~done_r, st["rstep"] + 1, st["rstep"])
            lstep = jnp.where(is_sl & ~done_l, st["lstep"] + 1, st["lstep"])

            accept = is_sh & inside
            forced = is_sh & ~inside & (st["nshrink"] + 1 >= cfg.max_shrink)
            acc = accept | forced
            contract = is_sh & ~inside & ~forced
            tR = jnp.where(contract & (t > 0.0), t, tR)
            tL = jnp.where(contract & (t <= 0.0), t, tL)
            nshrink = jnp.where(contract | forced, st["nshrink"] + 1, st["nshrink"])

            phase = jnp.where(is_ir, PH_INIT_L, phase)
            phase = jnp.where(is_il, after_init_l, phase)
            phase = jnp.where(done_r, jnp.where(need_l, PH_STEP_L, PH_SHRINK), phase)
            phase = jnp.where(done_l, PH_SHRINK, phase)

            # ---- record the baby: ring append at this iteration's slot ----
            slot = st["iters"] + 1  # scalar index -> dynamic_update_slice
            entry = jnp.concatenate(
                [probe, jnp.where(forced, logzero, logL)[:, None]], axis=1
            )
            ring = jax.lax.dynamic_update_slice(
                st["ring"], entry[:, None, :], (0, slot, 0)
            )
            rep_key = jnp.where(acc, st["rep"], T_ring)
            ring_rep = jax.lax.dynamic_update_slice(
                st["ring_rep"], rep_key[:, None], (0, slot)
            )

            new_rep = jnp.where(acc, st["rep"] + 1, st["rep"])
            finished = acc & (new_rep >= R)
            phase = jnp.where(
                acc, jnp.where(finished, PH_DONE, PH_INIT_R), phase
            ).astype(jnp.int32)

            nhat_n, w_n, grade_n = gather_repeat(new_rep)

            return dict(
                rep=new_rep,
                it=jnp.where(acc, 0, jnp.where(engaged, st["it"] + 1, st["it"])),
                phase=phase,
                tL=jnp.where(acc, 0.0, tL),
                tR=jnp.where(acc, 0.0, tR),
                rstep=jnp.where(acc, 1, rstep),
                lstep=jnp.where(acc, 1, lstep),
                nshrink=jnp.where(acc, 0, nshrink),
                need_r=jnp.where(acc, False, need_r),
                need_l=jnp.where(acc, False, need_l),
                x0=jnp.where(acc[:, None], probe, st["x0"]),
                nhat=jnp.where(acc[:, None], nhat_n, st["nhat"]),
                w=jnp.where(acc, w_n, st["w"]),
                grade=jnp.where(acc, grade_n, st["grade"]),
                ring=ring,
                ring_rep=ring_rep,
                nlike_g=nlike_g,
                iters=st["iters"] + 1,
            )

        st = jax.lax.while_loop(cond, body, state)

        overflow = jnp.any(st["phase"] != PH_DONE)  # exited on the iters cap

        # reorder the ring into repeat order: sort (rep, slot) int pairs per
        # lane — cheap one-time pass — then ONE batched row gather.  Each
        # repeat of a live lane is accepted exactly once, so after sorting by
        # rep the first R positions are repeats 0..R-1 in order; sentinel
        # (never-accepted) entries carry slot 0 = the default entry.
        slot_ids = jnp.where(
            st["ring_rep"] < T_ring,
            jnp.broadcast_to(jnp.arange(T_ring), (B, T_ring)),
            0,
        )
        _, slots_sorted = jax.lax.sort_key_val(
            st["ring_rep"], slot_ids, dimension=1
        )
        slots = slots_sorted[:, :R]
        entries = jnp.take_along_axis(st["ring"], slots[:, :, None], axis=1)
        cube = entries[:, :, :D]  # (B, R, D)
        logL_store = entries[:, :, D]

        # re-derive theta/phi from the accepted cubes in one batched pass
        # (bookkeeping, not counted in nlike; rows never accepted keep the
        # scan engine's zero theta/phi defaults)
        theta, phi, _ = calc_point_batch(cube.reshape(B * R, D))
        accepted = (slots > 0)[:, :, None]
        theta = jnp.where(accepted, theta.reshape(B, R, D), 0.0)
        phi = jnp.where(accepted, phi.reshape(B, R, cfg.n_phi), 0.0)

        babies = jnp.concatenate(
            [cube, theta, phi, logL_store[:, :, None]], axis=2
        ).reshape(B, R * stride)
        packed = jnp.concatenate(
            [
                babies,
                st["nlike_g"].astype(real_dtype()),
                jnp.broadcast_to(
                    overflow.astype(real_dtype()), (B,)
                )[:, None],
            ],
            axis=1,
        )
        return packed

    return epoch


def unpack_epoch(packed, cfg: EpochConfig):
    """Host-side unpack of the single epoch buffer produced by the kernel.

    Returns (cube (B,R,D), theta (B,R,D), phi (B,R,n_phi), logL (B,R),
    nlike (B, n_grades)) as float64 numpy arrays."""
    import numpy as np

    packed = np.asarray(packed, dtype=np.float64)
    D = cfg.n_dims
    R = cfg.total_repeats
    n_grades = len(cfg.grade_dims)
    stride = 2 * D + cfg.n_phi + 1
    B = packed.shape[0]
    per_baby = packed[:, : R * stride].reshape(B, R, stride)
    cube = per_baby[:, :, :D]
    theta = per_baby[:, :, D : 2 * D]
    phi = per_baby[:, :, 2 * D : 2 * D + cfg.n_phi]
    logL = per_baby[:, :, -1]
    nlike = packed[:, R * stride : R * stride + n_grades].astype(np.int64)
    return cube, theta, phi, logL, nlike


def epoch_overflowed(packed) -> bool:
    """True if a ring-engine epoch exhausted its ring (re-run with scan).
    Meaningful for ring-engine output only."""
    import numpy as np

    return bool(np.asarray(packed[:, -1]).any())


def epoch_loop_trips(packed) -> int:
    """Inner ``while_loop`` trips a scan-engine epoch took on one device."""
    import numpy as np

    return int(np.asarray(packed)[0, -1])


def pack_epoch_inputs(seed_cube, bound, cholesky):
    """Host-side pack of epoch inputs into one upload buffer:
    per lane [cube(D), bound, cholesky.ravel(D*D)]."""
    import numpy as np

    B, D = seed_cube.shape
    return np.concatenate(
        [seed_cube, bound[:, None], cholesky.reshape(B, D * D)], axis=1
    ).astype(np.float32)


def unpack_epoch_inputs(packed, n_dims: int):
    """Device-side unpack (inside jit) of the single input buffer."""
    D = n_dims
    seed_cube = packed[:, :D]
    bound = packed[:, D]
    chol = packed[:, D + 1 :].reshape(packed.shape[0], D, D)
    return seed_cube, bound, chol
