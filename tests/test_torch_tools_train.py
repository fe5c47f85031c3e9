"""`egohmr_tpu_torch/tools/compare_train_precision.py` against the JAX
package's `tools/compare_train_precision.py`: each tool's f32 and
bf16-mixed runs on the same weights, batches and draws, and the summary
and gates of both on the same curves."""
import contextlib
import io
import json
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import egohmr_tpu.data.synthetic as j_synthetic
import egohmr_tpu_torch.data as t_data
from egohmr_tpu.models import BodyRepStats as JStats
from egohmr_tpu.smpl import make_synthetic_model as j_make_smpl
from egohmr_tpu_torch.models import BodyRepStats
from egohmr_tpu_torch.smpl import make_synthetic_model
from egohmr_tpu_torch.tools import compare_train_precision as tool

from .test_torch_tools import jax_tool
from .test_torch_train import SMALL, jax_draws
from .torch_parity import tiny_pair, to_jax

B, P, V, STEPS = 4, 64, 64, 3


def test_first_steps_match_the_jax_tools(monkeypatch):
    """Three steps of each run, f32 and bf16-mixed, through each tool's
    `run` (the collision loss on, as the tools train): the tiny widths of
    `tests/test_torch_train.py` on one pair of weights, the tools' 8
    synthetic batches at 64 x 64 pixels and 64 points, and the draws that
    the JAX tool's step keys PRNGKey(i) give, handed to the port through
    its `step_draws`. The losses at that file's bars: rtol 1e-3 in f32 (the
    port's own three steps from the start), 2e-2 in bf16-mixed. Both runs
    of the port start from the same weights."""
    jtool = jax_tool("compare_train_precision")
    jcfg, tcfg, params, model = tiny_pair(seed=1, **SMALL)
    for mod, fn in ((j_synthetic, j_synthetic.synthetic_batch),
                    (t_data, t_data.synthetic_batch)):
        monkeypatch.setattr(mod, "synthetic_batch", partial(fn, img_size=64))
    monkeypatch.setattr(tool, "step_draws",
                        lambda i, dev: jax_draws(jax.random.PRNGKey(i), B, tcfg.cond_mask_prob))
    jbuilt = (jcfg, to_jax(params), JStats(jnp.zeros(144), jnp.ones(144)),
              j_make_smpl(num_vertices=V), B, P)
    tbuilt = (tcfg, model, BodyRepStats(torch.zeros(144), torch.ones(144)),
              make_synthetic_model(num_vertices=V), B, P)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    for mp, rtol in ((False, 1e-3), (True, 2e-2)):
        want = jtool.run(jbuilt, None, STEPS, mp, False, 0)[0]
        got = tool.run(tbuilt, None, STEPS, mp, 0)[0]
        assert len(got) == STEPS and np.isfinite(got).all()
        np.testing.assert_allclose(got, want, rtol=rtol, err_msg=f"mixed_precision={mp}")
    for k, v in model.state_dict().items():
        assert torch.equal(v, start[k]), k  # each run trains a copy


def _curves(seed: int, steps: int, gap: float):
    """One canned `run` result per precision: falling losses, the bf16 run
    `gap` above the f32 one, validation series and spreads."""
    rng = np.random.RandomState(seed)

    def floats(a):
        return [float(x) for x in a]

    l32 = floats(3.0 * np.exp(-np.arange(steps) / 40) + 0.05 * rng.rand(steps) + 0.5)
    l16 = floats(np.array(l32) * (1 + gap) + 0.01 * rng.randn(steps))
    vs = [25, 50, steps]

    def run(losses, scale):
        return (losses, vs, floats(scale * (0.5 + 0.1 * rng.rand(3))),
                floats(0.6 + 0.01 * rng.rand(3)), floats(0.5 + 0.01 * rng.rand(4)),
                floats(0.6 + 0.01 * rng.rand(4)), 1.0)

    return [run(l32, 1.0), run(l16, 1.0 + gap)]


@pytest.mark.parametrize("gap,ok", [(0.01, True), (0.2, False)], ids=["pass", "fail"])
def test_summary_and_gates_equal_the_jax_tools(monkeypatch, gap, ok):
    """`smooth`, and both tools' `main` on the same canned curves (each
    tool's `run` and `_build` replaced): the same summary line and the same
    exit code, for a bf16 run 1% above f32 (within --tol and --val_tol)
    and one 20% above (outside both)."""
    jtool = jax_tool("compare_train_precision")
    xs = list(np.random.RandomState(0).rand(60))
    assert tool.smooth(xs) == jtool.smooth(xs)
    assert tool.smooth(xs, 7) == jtool.smooth(xs, 7)
    argv = ["--steps", "80", "--out", "", "--cpu"]
    printed = {}
    for side, mod, build in (("jax", jtool, lambda quick: (None,) * 6),
                             ("port", tool, lambda quick, dev: (None,) * 6)):
        runs = iter(_curves(3, 80, gap))
        monkeypatch.setattr(mod, "_build", build)
        monkeypatch.setattr(mod, "make_val_fn", lambda *a: None)
        monkeypatch.setattr(mod, "run", lambda *a, **k: next(runs))
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = mod.main(argv)
        assert rc == (0 if ok else 1), side
        printed[side] = json.loads(out.getvalue().splitlines()[-1])
    assert printed["port"] == printed["jax"]
    assert printed["port"]["ok"] is ok
