"""``chip_smoke.py`` and the epoch profiler's trace reduction.

The smoke test's phases take their sizes as arguments, so the same checks
run here on the CPU at small sizes; the script itself refuses to run
without a GPU.  The ``gpu``-marked test runs phase 1 on the card.
"""

import json
import os
import sys

import jax
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "benchmarks"))

import chip_smoke  # noqa: E402
import profile_epoch  # noqa: E402


class _Device:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


class TestContract:
    def test_device_guard_raises_on_cpu(self):
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            chip_smoke.require_gpu(jax.devices())

    def test_main_fails_without_gpu_and_prints_no_result(self, capsys):
        with pytest.raises(RuntimeError):
            chip_smoke.main([])
        out = capsys.readouterr().out
        assert '"ok"' not in out

    @pytest.mark.parametrize("count", [1, 4])
    def test_last_line_is_the_contract_line(self, count):
        line = chip_smoke.contract_line([_Device()] * count)
        assert line == (
            '{"ok": true, "device": {"platform": "gpu", "kind": '
            '"NVIDIA H100 80GB HBM3", "count": %d}}' % count
        )
        assert json.loads(line)["device"]["count"] == count


class TestPhasesOnCpu:
    def test_flagship_phase_small(self, capsys):
        cpu = jax.devices("cpu")[0]
        chip_smoke.phase_flagship(
            cpu, cpu, B=256, ref_B=64, n_dims=4, num_repeats=20, n_bases=64
        )
        out = capsys.readouterr().out
        assert "FAIL" not in out and out.count("[pass]") == 8

    def test_four_device_phase_small(self, tmp_path, capsys):
        chip_smoke.phase_four(
            jax.devices()[:4], str(tmp_path), B=64, n_dims=4,
            num_repeats=8, run_dims=2,
        )
        out = capsys.readouterr().out
        assert "bitwise equal: True" in out and "FAIL" not in out

    def test_check_raises_on_failure(self, capsys):
        with pytest.raises(chip_smoke.CheckFailed, match="demo"):
            chip_smoke.check("demo", False, "detail")
        assert "[FAIL] demo: detail" in capsys.readouterr().out


_TRACE = """
planes {
  id: 1
  name: "/device:GPU:0"
  lines {
    id: 1
    name: "Stream #13(Compute)"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 2000000 }
    events { metadata_id: 2 offset_ps: 1000000 duration_ps: 2000000 }
    events { metadata_id: 3 offset_ps: 6000000 duration_ps: 1000000 }
    events { metadata_id: 1 offset_ps: 8000000 duration_ps: 2000000 }
  }
  lines {
    id: 2
    name: "XLA Ops"
    timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 9000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "loop_fusion" } }
  event_metadata { key: 2 value { id: 2 name: "input_reduce_fusion" } }
  event_metadata { key: 3 value { id: 3 name: "MemcpyDtoH" } }
}
planes {
  id: 2
  name: "/host:CPU"
  lines {
    id: 1
    name: "python"
    timestamp_ns: 0
    events { metadata_id: 1 offset_ps: 0 duration_ps: 50000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "flagship_epoch" } }
}
"""


class TestTraceReduction:
    def test_recorded_trace(self):
        pd = jax.profiler.ProfileData.from_text_proto(_TRACE)
        r = profile_epoch.reduce_trace(pd)
        # stream events only: 0-2, 1-3, 6-7, 8-10 us; union 3 + 1 + 2
        assert r["device_events"] == 4
        assert r["kernels"] == 3 and r["copies"] == 1
        assert r["window_ns"] == 10000
        assert r["busy_ns"] == 6000
        assert r["idle_share"] == pytest.approx(0.4)
        top = r["top_events"][0]
        assert top == {"name": "loop_fusion", "count": 2, "total_ns": 4000}

    def test_trace_without_device_events_raises(self):
        pd = jax.profiler.ProfileData.from_text_proto(
            _TRACE.split("planes {\n  id: 2")[0].replace("/device:GPU:0",
                                                        "/host:CPU")
        )
        with pytest.raises(ValueError, match="no GPU stream events"):
            profile_epoch.reduce_trace(pd)


@pytest.mark.gpu
def test_flagship_phase_on_card(gpu_device, capsys):
    """Phase 1 of the smoke test on the card, at a reduced batch."""
    chip_smoke.phase_flagship(
        gpu_device, jax.devices("cpu")[0], B=1024, ref_B=256, n_bases=512
    )
    assert "FAIL" not in capsys.readouterr().out
