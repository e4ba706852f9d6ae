"""Whitened chord-direction generation for the slice-sampling engine.

Batched re-expression of the reference direction machinery
(``src/polychord/chordal_sampling.f90:94-145`` +
``src/polychord/random_utils.F90:381-437``):

* per speed-grade g, directions span the subspace of dimensions
  [start(g), nDims) (its own block plus all faster blocks), drawn as columns of
  stacked Haar-random orthonormal bases so that every ``grade_nDims`` repeats
  span the whole subspace;
* the ``R = sum(num_repeats)`` slots are shuffled, keeping slot 0 on the first
  slow-grade direction (reference keeps the first evaluation slow);
* each direction is whitened by the cluster Cholesky L (lower-triangular, so
  slow coordinates stay untouched for fast-grade directions), normalised, and
  the initial slice width is ``w = 3 * |L n̂|``
  (``chordal_sampling.f90:73-82``).

Everything is generated for all B chains at once with per-chain fold_in keys,
so results are independent of how the chain batch is sharded across devices.

Every float32 matrix product here asks for ``Precision.HIGHEST``: at
default precision XLA may run a float32 product in TF32 (about three
decimal digits) on GPUs.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp


_HI = jax.lax.Precision.HIGHEST


def _gram_schmidt(gauss: jnp.ndarray, block: int = 5) -> jnp.ndarray:
    """Batched Gram-Schmidt orthonormalisation of the columns of
    ``gauss`` (..., dim, dim) with one reorthogonalisation pass (CGS2),
    blocked over columns.

    This is the same construction as the reference's
    ``random_orthonormal_basis`` (``random_utils.F90:381-403``) — Gram-Schmidt
    of a Gaussian matrix, which yields a Haar-distributed orthonormal basis
    (the residual projection keeps q_k · a_k > 0, i.e. the QR sign convention
    holds automatically; in exact arithmetic the blocked order computes the
    identical unique positive-diagonal-R factor).  Projecting each column
    block against all previous blocks with two batched products reads the
    Q buffer once per block instead of once per column.
    """
    dim = gauss.shape[-1]
    cols = []  # finished orthonormal column blocks, (..., dim, block) each

    for b0 in range(0, dim, block):
        v = gauss[..., :, b0 : b0 + block]
        if cols:
            q = jnp.concatenate(cols, axis=-1)  # (..., dim, b0)
            for _ in range(2):  # two sweeps: block CGS2
                coeff = jnp.einsum("...dk,...dj->...kj", q, v, precision=_HI)
                v = v - jnp.einsum("...dk,...kj->...dj", q, coeff, precision=_HI)
        # in-block CGS2, unrolled over <= block columns (static slices)
        done = []
        for k in range(v.shape[-1]):
            c = v[..., :, k : k + 1]
            if done:
                qb = jnp.concatenate(done, axis=-1)
                for _ in range(2):
                    coeff = jnp.einsum("...dk,...dj->...kj", qb, c, precision=_HI)
                    c = c - jnp.einsum(
                        "...dk,...kj->...dj", qb, coeff, precision=_HI
                    )
            norm = jnp.sqrt(jnp.sum(c * c, axis=-2, keepdims=True))
            done.append(c / jnp.maximum(norm, 1e-30))
        cols.append(jnp.concatenate(done, axis=-1))
    return jnp.concatenate(cols, axis=-1)


def _haar_bases(key, dim: int, count: int) -> jnp.ndarray:
    """``count`` columns drawn from ceil(count/dim) stacked Haar orthonormal
    bases of R^dim (equivalent of ``random_orthonormal_bases``)."""
    n_bases = -(-count // dim)  # ceil
    gauss = jax.random.normal(key, (n_bases, dim, dim))
    q = _gram_schmidt(gauss)
    cols = jnp.swapaxes(q, -1, -2).reshape(n_bases * dim, dim)  # rows = directions
    return cols[:count]  # (count, dim)


@functools.partial(
    jax.jit,
    static_argnames=("grade_dims", "num_repeats", "n_dims"),
)
def make_directions(
    chain_keys,  # (B,) batch of per-chain PRNG keys
    cholesky: jnp.ndarray,  # (B, D, D) per-chain cluster Cholesky
    *,
    grade_dims: Tuple[int, ...],
    num_repeats: Tuple[int, ...],
    n_dims: int,
    shared_perm_key=None,
):
    """Generate whitened slice directions for a batch of chains.

    Returns (nhats (B,R,D) unit directions in cube space, w (B,R) initial
    widths, speeds (B,R) int32 grade index of each slot).

    ``shared_perm_key``: use ONE slot permutation for the whole batch
    (derived from this key) instead of per-chain shuffles.  Every engine
    passes it (derived from the epoch key, so it is shard-invariant):
    sharing the slot ORDER across chains couples nothing — directions
    stay per-chain random and chains are independent — while the
    per-chain variant materialises a (B, R, R) one-hot, and the graded
    engine requires the shared order anyway.  Documented deviation: the
    reference shuffles per chord set (shuffle_deck,
    chordal_sampling.f90:132-139); statistically a seed change.
    ``None`` (direct callers/tests) keeps per-chain shuffles.
    """
    R = int(sum(num_repeats))
    B = chain_keys.shape[0]

    def _perm_of(key):
        # Shuffle slots 1..R-1, keeping the first slot slow
        # (chordal_sampling.f90:132-139).
        if R > 1:
            perm_tail = jax.random.permutation(key, R - 1) + 1
            return jnp.concatenate(
                [jnp.zeros((1,), dtype=perm_tail.dtype), perm_tail]
            )
        return jnp.zeros((1,), jnp.int32)

    speeds_r = jnp.concatenate(
        [
            jnp.full((reps,), g, dtype=jnp.int32)
            for g, reps in enumerate(num_repeats)
        ]
    )  # (R,)

    def per_chain(chain_key):
        blocks = []
        keys = jax.random.split(chain_key, len(num_repeats) + 1)
        for g, reps in enumerate(num_repeats):
            start = int(sum(grade_dims[:g]))
            sub = n_dims - start  # grade spans [start, nDims)
            dirs = _haar_bases(keys[g], sub, reps)  # (reps, sub)
            full = jnp.zeros((reps, n_dims)).at[:, start:].set(dirs)
            blocks.append(full)
        nhats = jnp.concatenate(blocks, axis=0)  # (R, D)
        return nhats, _perm_of(keys[-1])

    nhats, perm = jax.vmap(per_chain)(chain_keys)
    speeds = jnp.broadcast_to(speeds_r, (B, R))

    if R > 1 and shared_perm_key is not None:
        # Batch-shared slot order: ONE (R, R) one-hot permutation applied
        # as a single (R, R) @ (R, B*D) product.  The per-chain variant
        # materialises a (B, R, R) one-hot; sharing the *order* of slots
        # across chains couples nothing — the directions themselves stay
        # per-chain random and chains are processed independently — and
        # is required anyway by the graded-likelihood engine.  Slot 0
        # stays slow-grade as the reference requires
        # (chordal_sampling.f90:132-139).  HIGHEST keeps the x*1 + 0
        # sums bitwise identical to a gather (a TF32 product would round
        # the operands).
        perm1 = _perm_of(shared_perm_key)  # (R,)
        onehot = (
            perm1[:, None] == jnp.arange(R, dtype=perm1.dtype)[None, :]
        ).astype(nhats.dtype)  # (R_dst, R_src)
        nhats = jnp.einsum("rq,bqd->brd", onehot, nhats, precision=_HI)
        speeds = jnp.broadcast_to(speeds_r[perm1], (B, R))
    elif R > 1:
        # per-chain shuffles (the reference's exact behaviour,
        # shuffle_deck per chord set), as a batched 0/1 product
        onehot = (
            perm[:, :, None] == jnp.arange(R, dtype=perm.dtype)[None, None, :]
        ).astype(nhats.dtype)  # (B, R_dst, R_src)
        nhats = jnp.einsum("brq,bqd->brd", onehot, nhats, precision=_HI)
        speeds = (
            (onehot * speeds[:, None, :].astype(nhats.dtype))
            .sum(axis=2)
            .astype(jnp.int32)
        )

    # Whiten: chord direction in cube space is L @ n̂; initial width is
    # 3x its length (chordal_sampling.f90:73-82).  TF32 rounding here could
    # not bias the sampler (slice sampling is exact for any direction drawn
    # independently of the current point, and w and the normalisation come
    # from the same rounded product), but it would make every chain on a
    # GPU differ from the CPU's from its first probe; full float32 costs
    # little at these shapes (PERF.md).
    whitened = jnp.einsum("brd,bed->bre", nhats, cholesky, precision=_HI)
    norms = jnp.sqrt(jnp.sum(whitened * whitened, axis=2))
    safe = jnp.maximum(norms, 1e-300)
    unit = whitened / safe[:, :, None]
    w = 3.0 * norms
    return unit, w, speeds
