"""The port's own spans and phase markers (`utils/profiling.py`) on the CPU:
`span` records nothing without a profiler and, under one, a `Span` per
entry (name, parent, request, host clock) and an `egohmr.*` range in the
exported trace; a `Predictor` request's spans and stage 1's `forward`'s;
the bounded store; `mark` does nothing on the CPU. The markers on the card
are in `tests/test_torch_gpu.py`."""
import contextlib
import json
from collections import deque

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from egohmr_tpu_torch.data import synthetic_batch, to_torch
from egohmr_tpu_torch.diffusion import make_schedule
from egohmr_tpu_torch.models import BodyRepStats, EgoHMR, EgoHMRConfig, ProHMR, ProHMRConfig
from egohmr_tpu_torch.models import init_random_, prohmr
from egohmr_tpu_torch.serving import Predictor
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.utils import profiling
from egohmr_tpu_torch.utils.profiling import clear, mark, marking, recorded, span

SERVE = {"serve.submit": ("serve.upload", "serve.launch", "serve.readback"),
         "serve.result": ("serve.wait", "serve.unpack")}


def cpu_profile():
    return profile(activities=[ProfilerActivity.CPU])


def annotations(prof, tmp_path):
    """The user annotations of an exported Chrome trace, in time order."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [e["name"] for e in sorted(events, key=lambda e: e.get("ts", 0))
            if e.get("cat") == "user_annotation"]


def test_span_without_a_profiler_records_nothing():
    clear()
    assert not torch._C._autograd._profiler_enabled()
    with span("outer", request=1) as s:
        with span("inner"):
            torch.ones(4).sum()
    assert s is None and recorded() == []
    # one shared no-op: no range is opened, so no egohmr.* event exists
    assert isinstance(span("a"), contextlib.nullcontext) and span("a") is span("b")


def test_nested_spans_under_the_profiler(tmp_path):
    """Each span entered records its name, its parent's index, its request
    (its own or its parent's) and its host-clock interval, in the order
    entered; the trace holds one `egohmr.<name>` range per span."""
    clear()
    with cpu_profile() as prof:
        with span("outer", request=7):
            with span("inner"):
                torch.ones(4).sum()
            with span("second"):
                with span("third", request=8):
                    pass
        with span("alone"):
            pass
    recs = recorded()
    assert [r.name for r in recs] == ["outer", "inner", "second", "third", "alone"]
    outer, inner, second, third, alone = recs
    assert [r.index for r in recs] == sorted(r.index for r in recs)
    assert (inner.parent, second.parent, third.parent) == (outer.index,) * 2 + (second.index,)
    assert outer.parent is None and alone.parent is None
    assert [r.request for r in recs] == [7, 7, 7, 8, None]
    for r in recs:
        assert r.end_ns is not None and r.start_ns <= r.end_ns
    assert outer.start_ns <= inner.start_ns and inner.end_ns <= second.start_ns
    assert third.end_ns <= second.end_ns <= outer.end_ns <= alone.start_ns
    names = annotations(prof, tmp_path)
    assert [n for n in names if n.startswith("egohmr.")] == \
        ["egohmr." + n for n in ("outer", "inner", "second", "third", "alone")]
    clear()
    assert recorded() == []


def test_the_store_is_bounded(monkeypatch):
    """The store keeps the newest `STORE_SPANS` spans (here a store of 8):
    a long profiled session cannot grow it without end."""
    assert profiling._store.maxlen == profiling.STORE_SPANS
    monkeypatch.setattr(profiling, "_store", deque(maxlen=8))
    with cpu_profile():
        for i in range(20):
            with span(f"s{i}"):
                pass
    assert [r.name for r in recorded()] == [f"s{i}" for i in range(12, 20)]


def test_mark_does_nothing_on_the_cpu(monkeypatch):
    """On CPU tensors `mark` neither builds nor launches, under a profiler
    and inside `marking()`; a phase it does not know raises."""
    from egohmr_tpu_torch import _build

    def no_build(name):
        raise AssertionError(f"built {name}")

    monkeypatch.setattr(_build, "load", no_build)
    x = torch.ones(2)
    with cpu_profile(), marking():
        for phase in profiling.PHASES:
            assert mark(phase, x) is None
    assert profiling._marking == 0
    with pytest.raises(ValueError, match="unknown phase"):
        mark("resnet", x)
    for phase in profiling.PHASES:
        name = profiling.MARKER_PREFIX + phase
        # the K1 roofline's kernels are matched by these substrings
        assert "stage_kernel" not in name and "context_kernel" not in name


def _tiny_predictor(**kw):
    cfg = EgoHMRConfig(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                       pointnet_hidden_dim=32, transl_embed_dim=16, timestep_embed_dim=32,
                       input_process_dim=32, gcn_hid_dim=16, gcn_layers=1)
    model = init_random_(EgoHMR(cfg), seed=0).eval()
    return Predictor(model, cfg, make_synthetic_model(num_vertices=64),
                     BodyRepStats(torch.zeros(144), torch.ones(144)),
                     make_schedule(50, "cosine", "ddim5"), device="cpu", batch_size=2,
                     pointnet_impl="xla", **kw)


def test_predictor_spans_once_per_request(tmp_path):
    """Under the profiler every request of a CPU `Predictor` records
    `serve.submit` over its upload, launch and readback and `serve.result`
    over its wait and unpack, once, all with the request's number; the
    children lie inside their parent, and the trace holds the ranges.
    Without a profiler, requests record nothing."""
    pred = _tiny_predictor(max_inflight=2)
    batches = [synthetic_batch(2, num_scene_points=128, img_size=64, seed=s) for s in range(3)]
    clear()
    list(pred.map_batches(iter(batches)))
    assert recorded() == []
    with cpu_profile() as prof:
        outs = list(pred.map_batches(iter(batches)))
    assert len(outs) == 3
    recs = recorded()
    by_index = {r.index: r for r in recs}
    requests = sorted({r.request for r in recs})
    assert len(requests) == 3 and None not in requests
    for req in requests:
        mine = [r for r in recs if r.request == req]
        assert sorted(r.name for r in mine) == sorted(
            [p for p in SERVE] + [c for cs in SERVE.values() for c in cs])
        for parent, children in SERVE.items():
            (top,) = [r for r in mine if r.name == parent]
            assert top.parent is None
            kids = [r for r in mine if r.parent == top.index]
            assert [r.name for r in kids] == list(children)
            for r in kids:
                assert top.start_ns <= r.start_ns <= r.end_ns <= top.end_ns
    assert all(r.parent is None or r.parent in by_index for r in recs)
    names = annotations(prof, tmp_path)
    for name in (n for p, cs in SERVE.items() for n in (p, *cs)):
        assert names.count("egohmr." + name) == 3


def test_prohmr_forward_records_its_three_spans():
    """Stage 1's `forward` under the profiler: its conditioning, its flow
    and its bodies, once each, in order, at the top level."""
    cfg = ProHMRConfig(resnet_layers=18, img_feat_dim=512, scene_feat_dim=32,
                       pointnet_hidden_dim=32, flow_hidden=32, flow_layers=2, flow_depth=1,
                       fc_head_hidden=32)
    model = prohmr.init_random_(ProHMR(cfg), seed=0).eval()
    batch = to_torch(synthetic_batch(2, num_scene_points=128, img_size=64, seed=1), "cpu")
    smpl = make_synthetic_model(num_vertices=64)
    clear()
    with torch.no_grad():
        want = prohmr.forward(model, cfg, smpl, batch, 3,
                              generator=torch.Generator().manual_seed(2))
        assert recorded() == []
        with cpu_profile():
            got = prohmr.forward(model, cfg, smpl, batch, 3,
                                 generator=torch.Generator().manual_seed(2))
    recs = recorded()
    assert [r.name for r in recs] == ["prohmr.condition", "prohmr.glow", "prohmr.bodies"]
    assert all(r.parent is None for r in recs)
    assert recs[0].end_ns <= recs[1].start_ns and recs[1].end_ns <= recs[2].start_ns
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
