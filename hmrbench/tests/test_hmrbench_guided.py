"""The guided cells (`drivers/guided.py`: EgoHMR-VolSMPL's learned-SDF cell
and the mesh SDF's), at tiny widths on the CPU: each ends in one result
object with the contract's keys and the metrics BENCHMARK.json declares;
the plain reference agrees with the port run in float32; the control
fails the cell's limits; the readers of the guide marks and the field's
counter read what they should, and nothing where there is nothing; a run
loads no JAX."""
import json
import math
import subprocess
import sys

import pytest
import torch
import tiny_guided

from hmrbench import control
from hmrbench.lib import common, judge
from hmrbench.lib.cell import Reading
from hmrbench.lib.common import ROOT, read_json
from hmrbench.lib.trace import Trace

CELLS = list(tiny_guided.TINY)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]
# the numbers of the outputs and of the gradient, which float32 holds to
# rounding; the step's identity reads against |c_t g_t|, whose rounding
# floor is the output's
ROUNDING = ("pred_pose_6d.rel", "pred_betas.rel", "posed.pred_keypoints_3d.max",
            "posed.pred_keypoints_2d_full.max", "guide.grad.rel")


def declared(cell):
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", cells)}
    layer = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", cells)}
    return e2e, layer


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_line(cell):
    res = tiny_guided.run(cell, trace=0)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert set(res["metrics"]) == declared(cell)[0]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert {"guide.grad.rel", "guide.step.rel"} <= set(res["checks"])
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_line(cell):
    res = tiny_guided.run(cell, trace=1, seed=12)
    assert set(res["metrics"]) <= declared(cell)[1]
    host = ("mfu", "submit_ms")
    assert {m for m in res["metrics"] if m.startswith(host)} \
        == {m for m in declared(cell)[1] if m.startswith(host)}
    # the guide marks are the card's: none on the CPU; the counter is read
    assert "guide_device_ms.guided" not in res["metrics"]
    if cell == "egohmr-volsdf-ddpm50":
        t = tiny_guided.TINY[cell]
        rows = (t["collision"]["ddpm_threshold"] + 1) * t["images_per_request"] \
            * t["samples_per_image"] * 24 * t["inputs"]["scene_points"]
        assert res["metrics"]["field_rows.guided"]["value"] == rows
    else:
        assert "field_rows.guided" not in res["metrics"]


@pytest.mark.parametrize("cell", CELLS)
def test_reference_agrees_with_the_port(cell):
    res = tiny_guided.run(cell, f32=True, seed=21)
    assert res["correct"], res["checks"]
    for name in ROUNDING:
        assert res["checks"][name]["value"] < 1e-4, (name, res["checks"][name])


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_limits(cell):
    readings = control.readings(cell, 23, torch.device("cpu"),
                                overrides=tiny_guided.overrides(cell))["control"]
    limits = common.cell_files(cell)["workload"]["check"]["limits"]
    checks = judge.held(readings, limits)
    assert not all(c["ok"] for c in checks), checks
    assert all(math.isfinite(c["value"]) for c in checks)


def reader(name):
    return common.load_file(common.BENCH / "metrics" / f"{name}.py")


def trace(ops, units=2, counters=None):
    return Trace(start_s=0.0, window_s=1.0, busy_s=0.5, ops=ops, spans=[],
                 host_calls={"total": 0}, units=units, counters=dict(counters or {}))


def guided_ops(t0, steps=3, ms=2.0):
    """One request's guide marks from t0 (s): `steps` guided steps, each
    `ms` long between its marks, a kernel inside."""
    ops = []
    for i in range(steps):
        s = t0 + i * 0.01
        ops += [("egohmr_step_guide", s, 1e-6), ("void gemm", s + 1e-5, ms * 1e-3 - 2e-5),
                ("egohmr_step_guide_end", s + ms * 1e-3, 1e-6)]
    return ops


def test_guide_marks_per_request():
    ops = guided_ops(0.0) + guided_ops(0.1) + [("egohmr_step_guide", 0.2, 1e-6)]
    counts = {"field_flops": 67e12 * 0.003}
    r = Reading(window={}, spans={}, counts=counts, trace=trace(ops))
    assert reader("guide_device_ms.guided").read(r) == pytest.approx(6.0, rel=1e-9)
    assert reader("field_roofline.guided").read(r) == pytest.approx(50.0, rel=1e-9)
    mod = reader("field_rows.guided")
    assert mod.read(r) is None
    r = Reading(window={}, spans={}, counts=counts,
                trace=trace(ops, counters={"field_rows": 264.0}))
    assert mod.read(r) == 132.0
    for name in ("guide_device_ms.guided", "field_rows.guided", "field_roofline.guided"):
        assert reader(name).MOVES == "bodies_per_s"


def test_guide_marks_absent_read_none():
    """Without marks (the bulk cell, an older program), without a trace, or
    without the field's count, each reader gives None."""
    phases = [(f"egohmr_phase_{p}", 0.001 * i, 1e-6)
              for i, p in enumerate(("image", "scene", "sampler", "smpl", "end"))]
    for r in (Reading(window={}, spans={}, counts={"flops": 1.0}, trace=trace(phases)),
              Reading(window={}, spans={}, counts={"flops": 1.0})):
        for name in ("guide_device_ms.guided", "field_rows.guided", "field_roofline.guided"):
            assert reader(name).read(r) is None, name
    r = Reading(window={}, spans={}, counts={}, trace=trace(guided_ops(0.0)))
    assert reader("field_roofline.guided").read(r) is None


def test_guide_marks_leave_the_phases_whole():
    """A guided request's marks sit inside its sampler phase and leave the
    five phases' reader whole."""
    from hmrbench.lib.program_spans import request_phases

    ops = [("egohmr_phase_image", 0.0, 1e-6), ("egohmr_phase_scene", 0.001, 1e-6),
           ("egohmr_phase_sampler", 0.002, 1e-6)] + guided_ops(0.003) + \
        [("egohmr_phase_smpl", 0.05, 1e-6), ("egohmr_phase_end", 0.051, 1e-6)]
    assert len(request_phases(trace(ops))) == 1


PROBE = """
import json, sys
sys.path.insert(0, {root!r}); sys.path.insert(0, {tests!r})
import tiny_guided
from hmrbench.lib import common
tiny_guided.run({cell!r})
print(json.dumps(common.forbidden_modules()))
"""


@pytest.mark.parametrize("cell", CELLS)
def test_a_guided_run_loads_no_jax(cell):
    out = subprocess.run([sys.executable, "-c", PROBE.format(
        root=str(common.ROOT), tests=str(common.BENCH / "tests"), cell=cell)],
        capture_output=True, text=True, timeout=600, check=True).stdout
    assert json.loads(out.strip().splitlines()[-1]) == []
