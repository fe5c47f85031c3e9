"""The port's counterparts of the JAX package's last five `tools/` scripts
(`egohmr_tpu_torch/tools/`): each keeps the JAX tool's flags and defaults
but for the device flags, and refuses to run without a card unless asked
for the CPU; and `probe_gcn` against `egohmr_tpu`'s GCN. The tools'
results against the JAX tools are held in `test_torch_tools_*.py`."""
import argparse
import importlib
import json
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.models.egohmr import _ADJ
from egohmr_tpu.nn.gcn import modulated_gcn_forward as j_gcn_forward
from egohmr_tpu_torch.models.egohmr import _adjacency
from egohmr_tpu_torch.nn import cast_params_bf16
from egohmr_tpu_torch.tools import probe_gcn

from .torch_parity import tiny_pair, to_jax, to_np

TOOLS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools")

# tool: (argv both parsers need, flags only the JAX tool has, flags only the
# port has, flags whose default differs)
FLAGS = {
    "real_weights_eval": (["--stage1_checkpoint", "a.pt", "--stage2_checkpoint", "b.pt"],
                          {"platform"}, {"device"}, set()),
    "visualize_results": (["--results", "r.pkl"], set(), {"device"}, set()),
    # JAX's --cpu defaults to true there (--tpu clears it); the port's
    # --device defaults to the card
    "measure_guidance_reuse_deviation": ([], set(), {"device"}, {"cpu"}),
    "compare_train_precision": ([], set(), {"device"}, {"out"}),
    "probe_gcn": ([], set(), {"device", "quick"}, set()),
}


class _Parsed(Exception):
    pass


def parsed_flags(main, argv, monkeypatch) -> dict:
    """The namespace a tool's `main(argv)` parses, its run stopped there."""
    parse = argparse.ArgumentParser.parse_args

    def grab(self, args=None, namespace=None):
        raise _Parsed(vars(parse(self, args, namespace)))

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed) as got:
            main(argv)
    return got.value.args[0]


def jax_tool(name):
    if TOOLS_DIR not in sys.path:
        sys.path.insert(0, TOOLS_DIR)
    return importlib.import_module(name)


def port_tool(name):
    return importlib.import_module(f"egohmr_tpu_torch.tools.{name}")


@pytest.mark.parametrize("name", list(FLAGS))
def test_tool_has_the_jax_tools_flags_and_defaults(name, monkeypatch):
    argv, jax_only, port_only, changed = FLAGS[name]
    j = parsed_flags(jax_tool(name).main, argv, monkeypatch)
    t = parsed_flags(port_tool(name).main, argv, monkeypatch)
    assert set(j) - set(t) == jax_only and set(t) - set(j) == port_only
    same = set(j) & set(t) - changed
    assert {k: j[k] for k in same} == {k: t[k] for k in same}
    if "device" in t:
        assert t["device"] == "cuda"
    if name == "compare_train_precision":
        assert t["out"].endswith(os.path.join("artifacts", "h100_train_precision_overlay.json"))
        assert j["out"].endswith(os.path.join("artifacts", "train_precision_overlay.json"))


@pytest.mark.parametrize("name", list(FLAGS))
def test_tool_refuses_a_missing_card(name):
    """No CPU fallback: without a card and without --cpu / --device cpu the
    tool fails before it runs anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_tool(name).main(FLAGS[name][0])


# ------------------------------------------------------------- probe_gcn
def test_probe_gcn_variants_match_the_jax_gcn():
    """`full` is the JAX package's `modulated_gcn_forward(input_h=)` on the
    same weights and inputs (f32, rtol/atol 1e-4); `wcat` is `full`'s
    function in f32 (rtol/atol 1e-5) and passes the tool's bf16 gate (2e-2);
    the skeletons keep the shapes."""
    _, tcfg, params, model = tiny_pair(seed=2)
    rng = np.random.RandomState(3)
    a, b = (rng.randn(6, 24, tcfg.gcn_hid_dim).astype(np.float32) for _ in range(2))
    want, _ = j_gcn_forward(to_jax(params["diffusion_model"]), _ADJ, None, train=False,
                            input_h=(jnp.asarray(a), jnp.asarray(b)))
    fns = probe_gcn.variants(model.diffusion_model, _adjacency(torch.device("cpu")))
    at, bt = torch.tensor(a), torch.tensor(b)
    with torch.no_grad():
        full = fns["full"](at, bt)
        np.testing.assert_allclose(to_np(full), np.asarray(want), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(to_np(fns["wcat"](at, bt)), to_np(full), rtol=1e-5, atol=1e-5)
        for k in ("skeleton", "wcat_skel"):
            assert fns[k](at, bt).shape == full.shape
        f16 = probe_gcn.variants(cast_params_bf16(model).diffusion_model,
                                 _adjacency(torch.device("cpu")))
        a16, b16 = at.to(torch.bfloat16), bt.to(torch.bfloat16)
        np.testing.assert_allclose(to_np(f16["wcat"](a16, b16)), to_np(f16["full"](a16, b16)),
                                   rtol=2e-2, atol=2e-2)


def test_probe_gcn_prints_one_json_line(capsys):
    assert probe_gcn.main(["--quick", "--cpu", "--batch", "4", "--reps", "1", "--n1", "1",
                           "--n2", "2"]) == 0
    lines = [x for x in capsys.readouterr().out.splitlines() if x.startswith("{")]
    assert len(lines) == 1
    d = json.loads(lines[0])
    assert d["metric"] == "gcn_denoiser_ms_per_call_by_variant" and d["batch_fused"] == 4
    assert set(d["results"]) == {"full", "fused", "skeleton", "wcat", "wcat_skel"}
    assert d["device"] == "cpu" and d["kernel_ms"]["full"] is None
    # the card's bound at the tiny widths: 8 hidden products of [96, 64] x [64, 64]
    assert d["roofline_ms"] == pytest.approx(8 * 2 * 96 * 64 * 64 / 989e12 * 1e3)
