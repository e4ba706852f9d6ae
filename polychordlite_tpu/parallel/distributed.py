"""Multi-host initialisation.

The reference scales across nodes with ``mpirun`` (every rank runs the same
binary; rank assignment inside ``NestedSampling`` — SURVEY §5.8).  The
JAX equivalent is multi-controller SPMD: every host runs the same
program, ``jax.distributed.initialize`` wires the processes together, and the
chain batch shards over the global mesh exactly as it does over local
devices (the epoch issues no collectives, so scaling is linear and the
per-lane RNG keeps results identical to a single-host run of the same total
batch).

Host-side administration runs redundantly-deterministically on every process
(same seeds, same numpy state), which is the single-controller analogue of
the reference's broadcast-free synchronous mode; only process 0 writes files.
"""

from __future__ import annotations

import jax


def initialise_distributed(
    coordinator_address=None, num_processes=None, process_id=None
) -> int:
    """Initialise multi-host JAX if requested via arguments or the standard
    JAX_COORDINATOR_ADDRESS / cluster auto-detection.  Returns the process
    index (0 on single-host)."""
    if num_processes is not None and num_processes > 1:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    return jax.process_index()


def is_root() -> bool:
    """True on the process that owns file output (rank 0 in the reference)."""
    return jax.process_index() == 0


def broadcast_from_root(arr):
    """Adopt process 0's value on every process (reference: MPI_BCAST of
    root-decided quantities — the RNG seed, ``random_utils.F90:26-109``, and
    the timed per-grade speeds, ``generate.F90:303-309``).  Wall-clock-derived
    values differ per process; redundant-deterministic administration
    requires every process to use root's."""
    import numpy as np

    if jax.process_count() == 1:
        return arr
    from jax.experimental import multihost_utils as mhu

    return np.asarray(mhu.broadcast_one_to_all(np.asarray(arr)))


def all_any_flags(flag: bool):
    """(all_true, any_true) of a per-process boolean, agreed by every
    process.  Used to turn per-process configuration mismatches (e.g. a
    resume file visible on some hosts only) into the SAME error on every
    process instead of a deadlock in the next collective."""
    import numpy as np

    if jax.process_count() == 1:
        return bool(flag), bool(flag)
    from jax.experimental import multihost_utils as mhu

    flags = np.asarray(
        mhu.process_allgather(np.asarray(int(bool(flag)), np.int32))
    )
    return bool(flags.min()), bool(flags.max())
