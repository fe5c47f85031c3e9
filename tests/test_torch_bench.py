"""The port's measurement entry points on the CPU: every mode of `python
-m egohmr_tpu_torch.bench` and `tools/profile_serving.py` at `--quick
--cpu --iters 1` (one JSON line under the JAX bench's metric name), and
their fast failure without a CUDA device.
"""
import json

import numpy as np
import pytest
import torch

from egohmr_tpu_torch import bench
from egohmr_tpu_torch.tools import profile_serving


# (argv, metric, unit): bench.py's metric names, bench.py:207 (the
# unreachable-device line), :522, :693, :783, :878, :1023;
# tools/profile_serving.py:154
BENCH_MODES = [
    ([], "ddim5_samples_per_sec_per_chip", "samples/s"),
    (["--guided"], "guided_ddpm50_samples_per_sec_per_chip", "samples/s"),
    (["--guided-ddim"], "guided_ddim5_samples_per_sec_per_chip", "samples/s"),
    (["--serving"], "serving_predictor_samples_per_sec_per_chip", "samples/s"),
    (["--serving", "--pack16"], "serving_predictor_samples_per_sec_per_chip_pack16",
     "samples/s"),
    (["--train"], "train_step_imgs_per_sec_per_chip", "imgs/s"),
    (["--host"], "host_pipeline_imgs_per_sec", "imgs/s"),
]
TOOLS = [
    (profile_serving, ["--sweep", "1", "--stream", "3", "--reps", "1"], "serving_profile"),
]


def _one_json_line(capsys) -> dict:
    out = capsys.readouterr().out
    lines = [line for line in out.splitlines() if line.startswith("{")]
    assert len(lines) == 1, out
    return json.loads(lines[0])


@pytest.mark.parametrize("argv,metric,unit", BENCH_MODES, ids=lambda a: str(a))
def test_bench_mode_prints_one_json_line(argv, metric, unit, capsys):
    """Each mode at --quick --cpu --iters 1: one JSON line with bench.py's
    metric name, a positive value, the CPU named as the device and no
    baseline; every request program a mode times is handed to the request
    hook first, and one untimed request of it runs."""
    names = []

    def hook(name, request):
        names.append(name)
        request()

    assert bench.main(argv + ["--quick", "--cpu", "--iters", "1"], request_hook=hook) == 0
    d = _one_json_line(capsys)
    assert (d["metric"], d["unit"]) == (metric, unit)
    assert d["value"] > 0 and np.isfinite(d["value"])
    assert d["extra"]["device"] == "cpu" and d["extra"]["platform"] == "cpu"
    assert d["vs_baseline"] is None
    assert not any(k.startswith("vs_baseline") or k == "baseline" for k in d["extra"])
    if argv == []:
        assert d["companion_benchmarks"] is None
        assert names == ["ddim5"]
    elif argv == ["--train"]:
        assert d["extra"]["precision"] == "bf16_mixed" and d["extra"]["collision_loss"]
        assert names == ["train step"]
    elif argv == ["--host"]:
        assert names == [] and "device_train_budget_imgs_per_sec" not in d["extra"]
    else:
        assert len(names) == 1


@pytest.mark.parametrize("tool,argv,metric", TOOLS, ids=lambda a: getattr(a, "__name__", ""))
def test_tool_prints_one_json_line(tool, argv, metric, capsys):
    """The tool at --quick --cpu --iters 1: one JSON line with the JAX
    tool's metric name and its fields; on the CPU the device columns are
    null."""
    names = []
    assert tool.main(argv + ["--quick", "--cpu", "--iters", "1"],
                     request_hook=lambda name, request: names.append(name)) == 0
    d = _one_json_line(capsys)
    assert d["metric"] == metric and d["device"] == "cpu"
    for k in ("submit_ms", "d2h_ms", "blocking_ms", "device_ms_host_clock"):
        assert d[k] > 0, k
    assert d["device_ms"] is None and d["profile"]["kernel_launches"] is None
    assert list(d["steady_ms_by_inflight"]) == ["1"] and names == ["serving"]


@pytest.mark.parametrize("run,argv,metric", [
    *[(bench.main, argv, metric) for argv, metric, _ in BENCH_MODES],
    *[(tool.main, [], metric) for tool, _, metric in TOOLS],
], ids=lambda a: str(a) if isinstance(a, list) else "")
def test_no_cuda_device_fails_fast(run, argv, metric, capsys, monkeypatch):
    """Without a CUDA device and without --cpu: exit 1 and one JSON line,
    the mode's metric with a null value and an error. Nothing runs on the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench, "random_model", lambda *a, **k: pytest.fail("ran"))
    assert run(argv) == 1
    d = _one_json_line(capsys)
    assert d["metric"] == metric and d["value"] is None
    assert "no CUDA device" in d["error"]
