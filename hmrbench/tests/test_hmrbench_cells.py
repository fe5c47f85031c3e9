"""Each cell, at tiny widths on the CPU, ends in one result object with the
contract's keys; the command without a card exits 1 and prints nothing."""
import json
import os
import subprocess
import sys

import pytest
import torch
import tiny_cells

from hmrbench.lib.common import ROOT, read_json

CELLS = list(tiny_cells.TINY)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def declared(cell):
    """The metrics BENCHMARK.json declares for `cell`."""
    bench = read_json(ROOT / "BENCHMARK.json")
    cells = [w["name"] for w in bench["workloads"]]
    e2e = {m["name"] for m in bench["end_to_end"] if cell in m.get("workloads", cells)}
    layer = {m["name"] for m in bench["per_layer"] if cell in m.get("workloads", cells)}
    return e2e, layer


@pytest.mark.parametrize("cell", CELLS)
def test_end_to_end_line(cell):
    res = tiny_cells.run(cell, trace=0)
    assert list(res)[:5] == KEYS and list(res)[-1] == "checks"
    assert set(res["metrics"]) == declared(cell)[0]
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert all(set(c) == {"value", "limit"} for c in res["checks"].values())
    json.dumps(res)


@pytest.mark.parametrize("cell", CELLS)
def test_per_layer_line(cell):
    res = tiny_cells.run(cell, trace=1, seed=12)
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert any(m.startswith("mfu") for m in res["metrics"])
    # the host's metrics read something on the CPU too; the device's need a card
    assert set(res["metrics"]) <= declared(cell)[1]
    host = ("mfu", "submit_ms")
    assert {m for m in res["metrics"] if m.startswith(host)} \
        == {m for m in declared(cell)[1] if m.startswith(host)}
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list(res)[-1] == "checks"


def test_no_card_exits_1_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the refusal needs a machine without one")
    proc = subprocess.run([sys.executable, "hmrbench/run.py", "--workload", "egohmr-ddim5-bulk",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert proc.returncode == 1
    assert proc.stdout.strip() == ""
    assert "no CUDA device" in proc.stderr
