"""`egohmr_tpu_torch/tools/measure_guidance_reuse_deviation.py` against the
JAX package's `tools/measure_guidance_reuse_deviation.py`: the same
figures on the same weights, batch and x_T."""
import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu_torch.diffusion import sampler as tsampler
from egohmr_tpu_torch.tools import measure_guidance_reuse_deviation as tool

from .test_torch_tools import jax_tool
from .torch_parity import tiny_pair, to_jax

B, P = 2, 600
RAISE = 1000.0  # every guidance weight, on both sides
BAR_MM = 0.01


def _last_json(main, argv) -> dict:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        assert main(argv) in (0, None)
    return json.loads(out.getvalue().splitlines()[-1])


def test_figures_match_the_jax_tools(monkeypatch):
    """At the tiny widths (the JAX tool's `EgoHMRConfig()` and
    `init_egohmr` and the port tool's `EgoHMRConfig` and `random_model`
    swapped for one tiny pair of weights), batch 2, 600 scene points,
    --refresh 2: both tools sample from the same x_T with zero step noise,
    in f32 (bf16 switched off: the JAX tool's in its `sample_bodies`, the
    port tool's by leaving its model uncast; in bf16 the rounding,
    amplified by the guided sampler, moves the tiny bodies by more than the
    guidance does, the test below). Every guidance weight is
    raised 1000x on both sides (cond_grad_weight 2,000, ddim_scale 1,000),
    where the smallest figure, DDIM-5's mean guidance effect, reads 0.834
    mm, over 80x the bar: every mm figure of the two JSON lines within 0.01
    mm (read: 0.001 at most, the JSON's rounding)."""
    jtool = jax_tool("measure_guidance_reuse_deviation")
    import egohmr_tpu.diffusion as jdiff
    import egohmr_tpu.eval.pipeline as jpipeline
    import egohmr_tpu.models as jmodels

    jcfg, tcfg, params, model = tiny_pair(seed=1)
    x_T = np.random.RandomState(21).randn(B, 144).astype(np.float32)

    def normal(key, shape, dtype=None):
        # sample_loop draws x_T as normal(key, shape) and the step noise
        # as normal(key, shape, dtype)
        return jnp.asarray(x_T) if dtype is None else jnp.zeros(shape, dtype)

    def raised(cls):
        return lambda **kw: cls(cond_grad_weight=kw["cond_grad_weight"] * RAISE,
                                ddim_scale=RAISE * cls().ddim_scale)

    j_sample = jpipeline.sample_bodies
    monkeypatch.setattr(jmodels, "EgoHMRConfig", lambda: jcfg)
    monkeypatch.setattr(jmodels, "init_egohmr", lambda key, cfg: to_jax(params))
    monkeypatch.setattr(jdiff, "GuidanceConfig", raised(jdiff.GuidanceConfig))
    monkeypatch.setattr(jpipeline, "sample_bodies",
                        lambda *a, **kw: j_sample(*a, **{**kw, "bf16": False}))
    with monkeypatch.context() as m:
        m.setattr(jax.random, "normal", normal)
        want = _last_json(jtool.main, ["--points", str(P), "--refresh", "2"])

    t_sample = tool.sample_bodies
    monkeypatch.setattr(tool, "EgoHMRConfig", lambda: tcfg)
    monkeypatch.setattr(tool, "random_model", lambda cfg: model)
    monkeypatch.setattr(tool, "GuidanceConfig", raised(tool.GuidanceConfig))
    monkeypatch.setattr(tool, "cast_params_bf16", lambda m: m)
    monkeypatch.setattr(tool, "sample_bodies", lambda *a, **kw: t_sample(*a, **{
        **kw, "noise": torch.tensor(x_T)}))
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g, shard: torch.zeros_like(x))
    got = _last_json(tool.main, ["--points", str(P), "--refresh", "2", "--cpu"])

    assert {k: got[k] for k in want} == {**want, "modes": got["modes"]}
    assert got["extra"]["device"] == "cpu"
    assert set(got["extra"]["k2_launches"]) == {f"{m}_{r}" for m in ("ddim5", "ddpm50")
                                                 for r in ("unguided", "exact", "reuse2")}
    assert list(got["modes"]) == list(want["modes"]) == ["ddim5", "ddpm50"]
    for mode, entry in want["modes"].items():
        assert list(got["modes"][mode]) == list(entry) == ["guidance_effect_mm",
                                                           "reuse2_deviation_mm"]
        assert entry["guidance_effect_mm"]["mean"] > 10 * BAR_MM, mode
        for key, figs in entry.items():
            for stat, v in figs.items():
                assert got["modes"][mode][key][stat] == pytest.approx(v, abs=BAR_MM), (
                    mode, key, stat)


def test_bf16_rounding_outweighs_the_guidance_at_tiny_widths(monkeypatch, capsys):
    """Why the test above runs in f32: the port tool alone, at the tiny
    widths, on the same x_T with zero step noise and the tools' own weight
    (cond_grad_weight 2): in f32 the guidance moves the bodies by under
    0.2 mm; in bf16, as the tool runs, the exact and the unguided runs part
    by over 10x as much, the sampler amplifying the rounding of a slightly
    moved x_t (read: DDIM-5 0.013 mm in f32 and 16.307 in bf16, DDPM-50
    0.108 and 7.392, maxima). Prints both runs' JSON lines."""
    _, tcfg, _, model = tiny_pair(seed=1)
    x_T = np.random.RandomState(21).randn(B, 144).astype(np.float32)
    t_sample = tool.sample_bodies
    monkeypatch.setattr(tool, "EgoHMRConfig", lambda: tcfg)
    monkeypatch.setattr(tool, "random_model", lambda cfg: model)
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g, shard: torch.zeros_like(x))
    argv = ["--points", str(P), "--refresh", "2", "--cpu"]
    monkeypatch.setattr(tool, "sample_bodies", lambda *a, **kw: t_sample(
        *a, **{**kw, "noise": torch.tensor(x_T)}))
    bf16 = _last_json(tool.main, argv)["modes"]
    monkeypatch.setattr(tool, "cast_params_bf16", lambda m: m)
    f32 = _last_json(tool.main, argv)["modes"]
    with capsys.disabled():
        print(f"\nbf16: {json.dumps(bf16)}\nf32: {json.dumps(f32)}")
    for mode in ("ddim5", "ddpm50"):
        effect32 = f32[mode]["guidance_effect_mm"]["max"]
        assert effect32 < 0.2, (mode, f32)
        assert bf16[mode]["guidance_effect_mm"]["max"] > 10 * max(effect32, 1e-3), (mode, bf16)
