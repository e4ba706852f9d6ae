"""RunTimeInfo.snapshot(): the cheap write-behind copy must be a true
point-in-time snapshot — later mutation of the live state can never leak
into it (the deepcopy it replaces was O(ndead) on the critical path)."""

import copy
import math

import jax.numpy as jnp
import numpy as np

import polychordlite_tpu
from polychordlite_tpu.core.rti import (
    delete_outermost_point,
    update_posteriors,
)
from polychordlite_tpu.priors import UniformPrior


def _mid_run_rti(tmp_path):
    """A genuinely mid-run state: generated live points, 100 deletions,
    posterior stacks populated."""
    import jax

    from polychordlite_tpu.core.generate import generate_live_points
    from polychordlite_tpu.ops.evaluate import make_batched_calculator
    from polychordlite_tpu.settings import PolyChordSettings

    def lik(theta):
        return (
            -jnp.sum((theta / 0.1) ** 2) / 2
            - 2 * math.log(0.1 * math.sqrt(2 * math.pi)),
            [jnp.sum(theta**2)],
        )

    s = PolyChordSettings(2, 1)
    s.base_dir = str(tmp_path)
    s.file_root = "snap"
    s.nlive = 60
    s.num_repeats = 4
    s.seed = 5
    s.feedback = -1
    s = s.finalise()
    calc = make_batched_calculator(UniformPrior(-1, 1), lik, 2, 1)
    rng = np.random.default_rng(0)
    rti, _, _ = generate_live_points(calc, s, rng, jax.random.PRNGKey(0))
    rti._rng = rng
    rti.num_repeats = np.array([4])
    for _ in range(30):
        delete_outermost_point(rti)
    update_posteriors(rti)
    return rti


def _assert_equal_states(a, b):
    for name in vars(a):
        if name in ("settings", "_rng"):
            continue
        va, vb = getattr(a, name), getattr(b, name)
        if isinstance(va, np.ndarray):
            assert np.array_equal(va, vb), name
        elif isinstance(va, list):
            assert len(va) == len(vb), name
            for x, y in zip(va, vb):
                if isinstance(x, np.ndarray):
                    assert np.array_equal(x, y), name
                elif hasattr(x, "copy_array"):
                    assert np.array_equal(x.copy_array(), y.copy_array()), name
                else:
                    assert x == y, name
        elif hasattr(va, "copy_array"):
            assert np.array_equal(va.copy_array(), vb.copy_array()), name
        else:
            assert va == vb, name


def test_snapshot_is_immune_to_later_mutation(tmp_path):
    rti = _mid_run_rti(tmp_path)
    # the run was stopped at max_ndead: live points remain
    assert rti.total_nlive() > 0 and rti.ndead > 0

    snap = rti.snapshot()
    ref = copy.deepcopy(rti)  # ground truth of the same instant

    _assert_equal_states(snap, ref)

    # mutate the live state hard: deletions + posterior resampling
    for _ in range(min(20, rti.total_nlive() - 1)):
        delete_outermost_point(rti)
    update_posteriors(rti)
    assert rti.ndead == ref.ndead + 20

    # the snapshot still matches the point-in-time ground truth
    _assert_equal_states(snap, ref)


def test_snapshot_products_match_deepcopy_products(tmp_path):
    """The file products written from a snapshot are identical to those
    written from a deepcopy of the same instant."""
    import numpy.testing as npt

    from polychordlite_tpu.utils import io as io_mod

    rti = _mid_run_rti(tmp_path / "r")
    snap = rti.snapshot()
    ref = copy.deepcopy(rti)
    s = rti.settings

    for sub, state in (("a", snap), ("b", ref)):
        state.settings = copy.deepcopy(s)
        state.settings.base_dir = str(tmp_path / sub)
        from pathlib import Path

        Path(state.settings.cluster_dir_path).mkdir(parents=True, exist_ok=True)
        io_mod.write_dead_points(state.settings, state)
        io_mod.write_phys_live_points(state.settings, state)
        io_mod.write_stats_file(state.settings, state, np.zeros(1, np.int64))

    for fname in ("snap_dead-birth.txt", "snap_phys_live.txt", "snap.stats"):
        fa = (tmp_path / "a" / fname).read_text()
        fb = (tmp_path / "b" / fname).read_text()
        assert fa == fb, fname
