"""The readers of the program's own spans and phase markers
(`lib/program_spans.py` and the metrics that use it): from synthetic
device ops with marker kernels, and from the program's store filled by
spans entered under the profiler, each gives its value; without them, and
on a program that has no store, each gives None."""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hmrbench.lib import common
from hmrbench.lib.cell import Reading
from hmrbench.lib.trace import Trace

DEVICE = {"image_device_ms.serve": 4.0, "scene_device_ms.serve": 2.0,
          "sampler_device_ms.serve": 3.0, "smpl_device_ms.serve": 0.5}
HOST = {"upload_ms.serve": "serve.upload", "launch_ms.serve": "serve.launch",
        "wait_ms.serve": "serve.wait", "condition_ms.flow": "prohmr.condition",
        "glow_ms.flow": "prohmr.glow", "bodies_ms.flow": "prohmr.bodies"}


def reader(name):
    return common.load_file(common.BENCH / "metrics" / f"{name}.py")


def trace(ops, units=2):
    return Trace(start_s=0.0, window_s=1.0, busy_s=0.5, ops=ops, spans=[],
                 host_calls={"total": 0}, units=units)


def marked_request(t0, with_kernels=True):
    """One request's device ops from t0 (s): the five markers 2 us long,
    phases of 4, 2, 3 and 0.5 ms, and a kernel inside each phase."""
    ops, t = [], t0
    for phase, ms in zip(("image", "scene", "sampler", "smpl"), (4.0, 2.0, 3.0, 0.5)):
        ops.append((f"egohmr_phase_{phase}", t, 2e-6))
        if with_kernels:
            ops.append(("void at::native::elementwise_kernel", t + 1e-5, ms * 1e-3 - 2e-5))
        t += ms * 1e-3
    ops.append(("egohmr_phase_end", t, 2e-6))
    return ops


def test_device_phases_per_request():
    ops = marked_request(0.010) + marked_request(0.030)
    # a request cut off by the traced stretch's edge, and one marker out of
    # order, count for nothing
    ops += [("egohmr_phase_image", 0.050, 2e-6), ("egohmr_phase_scene", 0.054, 2e-6),
            ("egohmr_phase_smpl", 0.060, 2e-6), ("egohmr_phase_end", 0.061, 2e-6)]
    ops += [("H2D copy", 0.009, 1e-3)]
    r = Reading(window={}, spans={}, counts={}, trace=trace(ops))
    for name, want in DEVICE.items():
        mod = reader(name)
        assert (mod.MOVES, mod.UNIT) == ("bodies_per_s", "ms")
        assert mod.read(r) == pytest.approx(want, rel=1e-9), name


def test_device_phases_without_markers_are_none():
    for ops in ([], [("void at::native::elementwise_kernel", 0.0, 1e-3)],
                marked_request(0.0)[:-1]):
        r = Reading(window={}, spans={}, counts={}, trace=trace(ops))
        assert all(reader(n).read(r) is None for n in DEVICE)
    r = Reading(window={}, spans={}, counts={})
    assert all(reader(n).read(r) is None for n in DEVICE)


def fill_store(durations_ms):
    """Enter each span once per value under the profiler, then set its
    host-clock interval to the value."""
    from egohmr_tpu_torch.utils import profiling

    profiling.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for name, values in durations_ms.items():
            for ms in values:
                with profiling.span(name) as s:
                    pass
                s.end_ns = s.start_ns + int(ms * 1e6)


def test_host_spans_per_unit():
    # three older spans of each name before the traced stretch's two
    fill_store({span: [100.0] * 3 + [1.0 + i, 3.0 + i] for i, span in
                enumerate(HOST.values())})
    r = Reading(window={}, spans={}, counts={}, trace=trace([], units=2))
    for i, name in enumerate(HOST):
        mod = reader(name)
        assert mod.UNIT == "ms"
        assert mod.MOVES == ("bodies_per_s" if name.endswith(".serve") else "memory_peak_mib")
        assert mod.read(r) == pytest.approx(2.0 + i, rel=1e-9), name


def test_host_spans_without_the_store_are_none(monkeypatch):
    from egohmr_tpu_torch.utils import profiling

    fill_store({span: [1.0] for span in HOST.values()})
    r = Reading(window={}, spans={}, counts={}, trace=trace([], units=2))
    assert all(reader(n).read(r) is None for n in HOST)  # one span a name, two units
    assert all(reader(n).read(Reading(window={}, spans={}, counts={})) is None for n in HOST)
    fill_store({span: [1.0, 1.0] for span in HOST.values()})
    assert all(reader(n).read(r) == pytest.approx(1.0) for n in HOST)
    monkeypatch.delattr(profiling, "recorded")  # a program without the store
    assert all(reader(n).read(r) is None for n in HOST)
    profiling.clear()
    assert not torch._C._autograd._profiler_enabled()
