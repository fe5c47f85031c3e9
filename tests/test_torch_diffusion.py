"""Port parity: diffusion schedule tables and the DDPM / DDIM samplers,
guided and not, against egohmr_tpu (sampler bar rtol 2e-4, atol 1e-5, as in
tests/test_diffusion.py)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.diffusion import GuidanceConfig as JGuidanceConfig
from egohmr_tpu.diffusion import make_schedule as j_make_schedule
from egohmr_tpu.diffusion import sample_loop as j_sample_loop
from egohmr_tpu.diffusion import schedule as jsched
from egohmr_tpu_torch.diffusion import GuidanceConfig, make_schedule, sample_loop
from egohmr_tpu_torch.diffusion import sampler as tsampler
from egohmr_tpu_torch.diffusion import schedule as tsched


@pytest.mark.parametrize("respacing", ["ddim5", "", "10,5"])
@pytest.mark.parametrize("name", ["cosine", "linear"])
def test_tables_equal_jax(name, respacing):
    j = j_make_schedule(50, name, respacing)
    t = make_schedule(50, name, respacing)
    for f in dataclasses.fields(t):
        np.testing.assert_array_equal(getattr(t, f.name).numpy(),
                                      np.asarray(getattr(j, f.name)), err_msg=f.name)


def test_space_timesteps_and_eps_helpers():
    assert tsched.space_timesteps(50, "ddim5") == jsched.space_timesteps(50, "ddim5")
    s_t, s_j = make_schedule(50, "cosine", "ddim5"), j_make_schedule(50, "cosine", "ddim5")
    rng = np.random.RandomState(0)
    x, x0 = rng.randn(2, 4, 16).astype(np.float32)
    t = np.array([0, 1, 3, 4])
    eps_t = tsched.predict_eps_from_xstart(s_t, torch.tensor(x), torch.tensor(t), torch.tensor(x0))
    eps_j = jsched.predict_eps_from_xstart(s_j, jnp.asarray(x), jnp.asarray(t), jnp.asarray(x0))
    np.testing.assert_allclose(eps_t.numpy(), np.asarray(eps_j), rtol=1e-6, atol=1e-6)
    back = tsched.predict_xstart_from_eps(s_t, torch.tensor(x), torch.tensor(t), eps_t)
    np.testing.assert_allclose(back.numpy(), x0, rtol=1e-4, atol=1e-5)


class _Linear:
    """x0 = tanh(x @ W + emb[t]): the same denoiser in both frameworks."""

    def __init__(self, seed=0, d=16):
        rng = np.random.RandomState(seed)
        self.W = (rng.randn(d, d) * 0.3).astype(np.float32)
        self.emb = rng.randn(100, d).astype(np.float32) * 0.1

    def jax_fn(self):
        W, emb = jnp.asarray(self.W), jnp.asarray(self.emb)
        return lambda x, t: jnp.tanh(x @ W + emb[t])

    def torch_fn(self):
        W, emb = torch.tensor(self.W), torch.tensor(self.emb)
        return lambda x, t: torch.tanh(x @ W + emb[t])


@pytest.mark.parametrize("eta", [0.0, 0.5])
def test_ddim_sample_loop_matches_jax(eta, monkeypatch):
    """Same x_T on both sides; the step noise is zero on both sides (η > 0
    then exercises the σ-shrunk mean without random draws)."""
    den = _Linear()
    x_T = np.random.RandomState(1).randn(4, 16).astype(np.float32)
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g, shard: torch.zeros_like(x))
    for respacing in ("ddim5", ""):
        want, _ = j_sample_loop(j_make_schedule(50, "cosine", respacing), den.jax_fn(),
                                jax.random.PRNGKey(0), (4, 16), sampler="ddim",
                                eta=eta, noise=jnp.asarray(x_T))
        got, got_x0 = sample_loop(make_schedule(50, "cosine", respacing), den.torch_fn(),
                                  torch.Generator().manual_seed(0), (4, 16),
                                  sampler="ddim", eta=eta, noise=torch.tensor(x_T))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
        assert got_x0 is got


def test_sample_loop_draws_from_generator():
    """x_T and the η>0 step noise come from the caller's generator:
    reproducible per seed, different across seeds."""
    den, s = _Linear(), make_schedule(50, "cosine", "ddim5")
    run = lambda seed: sample_loop(s, den.torch_fn(), torch.Generator().manual_seed(seed),
                                   (3, 16), sampler="ddim", eta=1.0)[0]
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.allclose(run(3), run(4))


# ------------------------------------------- DDPM, guidance, warm start, dumps
@pytest.fixture
def zero_noise(monkeypatch):
    """JAX splits a PRNG key per step and the port draws from a generator,
    so per-step noise cannot match draw for draw: both are set to zero."""
    monkeypatch.setattr(jax.random, "normal",
                        lambda key, shape, dtype=jnp.float32: jnp.zeros(shape, dtype))
    monkeypatch.setattr(tsampler, "_step_noise", lambda x, g, shard: torch.zeros_like(x))


def _run_both(respacing, x_T, *, gw=None, jcfg=JGuidanceConfig(), tcfg=GuidanceConfig(), **kw):
    """The same chain through both packages, with the toy guidance
    grad = 0.01 x + gw when `gw` is given."""
    den = _Linear()
    jkw, tkw = dict(kw), dict(kw)
    if gw is not None:
        gw_j, gw_t = jnp.asarray(gw), torch.tensor(gw)
        jkw.update(guidance_fn=lambda x, t: x * 0.01 + gw_j, guidance=jcfg)
        tkw.update(guidance_fn=lambda x, t: x * 0.01 + gw_t, guidance=tcfg)
    for d, conv in ((jkw, jnp.asarray), (tkw, torch.tensor)):
        if d.get("init_data") is not None:
            d["init_data"] = conv(d["init_data"])
    want = j_sample_loop(j_make_schedule(50, "cosine", respacing), den.jax_fn(),
                         jax.random.PRNGKey(0), x_T.shape, noise=jnp.asarray(x_T), **jkw)
    got = sample_loop(make_schedule(50, "cosine", respacing), den.torch_fn(),
                      torch.Generator().manual_seed(0), x_T.shape,
                      noise=torch.tensor(x_T), **tkw)
    return got, want


@pytest.mark.parametrize("sampler,respacing", [("ddpm", ""), ("ddpm", "ddim5"), ("ddim", "")])
def test_unguided_zero_noise_chains_match_jax(zero_noise, sampler, respacing):
    """DDPM (the default sampler, as in JAX) and DDIM over 50 and 5 steps:
    rtol 2e-4, atol 1e-5."""
    x_T = np.random.RandomState(2).randn(4, 16).astype(np.float32)
    (got, _), (want, _) = _run_both(respacing, x_T, sampler=sampler)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    # "ddpm" is the default
    if sampler == "ddpm":
        (dflt, _), _ = _run_both(respacing, x_T)
        torch.testing.assert_close(dflt, got, rtol=0, atol=0)


@pytest.mark.parametrize("sampler,respacing,n_guided", [("ddim", "ddim5", 4), ("ddpm", "", 11)])
def test_guided_chains_match_jax(zero_noise, sampler, respacing, n_guided):
    """Guided DDIM-5 (eps shift at t_idx <= 3) and guided zero-noise DDPM-50
    (mean shift at t_idx <= 10, the fixed 0.01 coefficient below 5) with a
    toy guidance: rtol 2e-4, atol 1e-5, the bar of tests/test_diffusion.py.
    The guidance runs on exactly the gated steps and changes the result."""
    rng = np.random.RandomState(3)
    x_T, gw = rng.randn(4, 16).astype(np.float32), rng.randn(16).astype(np.float32) * 0.1
    (got, _), (want, _) = _run_both(respacing, x_T, gw=gw, sampler=sampler)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    (free, _), _ = _run_both(respacing, x_T, sampler=sampler)
    assert (got - free).abs().max() > 1e-3

    seen = []

    def counting(x, t):
        seen.append(int(t[0]))
        return torch.zeros_like(x)

    sample_loop(make_schedule(50, "cosine", respacing), _Linear().torch_fn(), None,
                (4, 16), sampler=sampler, guidance_fn=counting, noise=torch.tensor(x_T))
    assert seen == list(range(n_guided - 1, -1, -1))


def test_guidance_config_thresholds_match_jax(zero_noise):
    """Non-default thresholds and weights go through both packages alike:
    rtol 2e-4, atol 1e-5."""
    rng = np.random.RandomState(4)
    x_T, gw = rng.randn(4, 16).astype(np.float32), rng.randn(16).astype(np.float32) * 0.1
    kw = dict(cond_grad_weight=3.5, ddpm_threshold=20, ddpm_fixed_below=8,
              ddpm_fixed_coeff=0.02, ddim_threshold=1, ddim_scale=2.0)
    for sampler, respacing in (("ddpm", ""), ("ddim", "ddim5")):
        (got, _), (want, _) = _run_both(respacing, x_T, gw=gw, sampler=sampler,
                                        jcfg=JGuidanceConfig(**kw), tcfg=GuidanceConfig(**kw))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)


@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_dump_steps_match_jax(zero_noise, sampler):
    """Post-step snapshots at loop iterations (0, 17, 49), in the order
    asked for: rtol 2e-4, atol 1e-5; the last iteration's dump is the final
    sample."""
    x_T = np.random.RandomState(5).randn(4, 16).astype(np.float32)
    got, want = _run_both("", x_T, sampler=sampler, dump_steps=(0, 49, 17))
    assert len(got) == 3 and got[2].shape == (3, 4, 16)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=2e-4, atol=1e-5)
    torch.testing.assert_close(got[2][1], got[0], rtol=0, atol=0)
    assert got[1] is got[0]


def test_dump_steps_out_of_range_rejected():
    """An index past the chain's length raises in both packages; the
    warm-started chain is shorter."""
    s = make_schedule(50, "cosine", "ddim5")
    den = _Linear()
    with pytest.raises(ValueError, match="out of range"):
        sample_loop(s, den.torch_fn(), torch.Generator(), (2, 16), sampler="ddim",
                    dump_steps=(0, 17, 49))
    with pytest.raises(ValueError, match="out of range"):
        j_sample_loop(j_make_schedule(50, "cosine", "ddim5"), den.jax_fn(),
                      jax.random.PRNGKey(0), (2, 16), sampler="ddim", dump_steps=(0, 17, 49))
    with pytest.raises(ValueError, match=r"\[3\] out of range for a 3-step"):
        sample_loop(s, den.torch_fn(), torch.Generator(), (2, 16), sampler="ddim",
                    skip_timesteps=2, dump_steps=(3,))
    with pytest.raises(ValueError, match="unknown sampler"):
        sample_loop(s, den.torch_fn(), torch.Generator(), (2, 16), sampler="plms")


@pytest.mark.parametrize("init", ["data", "zeros"])
@pytest.mark.parametrize("sampler", ["ddpm", "ddim"])
def test_warm_start_matches_jax(zero_noise, sampler, init):
    """`skip_timesteps` with and without `init_data` (zeros then): the
    chain starts from q_sample(init_data, t_start - 1, x_T) and runs the
    remaining steps only. rtol 2e-4, atol 1e-5."""
    rng = np.random.RandomState(6)
    x_T = rng.randn(4, 16).astype(np.float32)
    init_data = rng.randn(4, 16).astype(np.float32) * 0.5 if init == "data" else None
    (got, _), (want, _) = _run_both("", x_T, sampler=sampler, skip_timesteps=30,
                                    init_data=init_data)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4, atol=1e-5)
    (cold, _), _ = _run_both("", x_T, sampler=sampler)
    assert (got - cold).abs().max() > 1e-3


def test_q_sample_and_posterior_mean_match_jax():
    s_t, s_j = make_schedule(50, "cosine", ""), j_make_schedule(50, "cosine", "")
    rng = np.random.RandomState(7)
    a, b = rng.randn(2, 4, 16).astype(np.float32)
    t = np.array([0, 7, 30, 49])
    T, J = torch.tensor, jnp.asarray
    np.testing.assert_allclose(tsched.q_sample(s_t, T(a), T(t), T(b)).numpy(),
                               np.asarray(jsched.q_sample(s_j, J(a), J(t), J(b))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(tsched.q_posterior_mean(s_t, T(a), T(b), T(t)).numpy(),
                               np.asarray(jsched.q_posterior_mean(s_j, J(a), J(b), J(t))),
                               rtol=1e-6, atol=1e-7)


def test_ddpm_step_noise_comes_from_the_generator():
    """DDPM draws its per-step noise from the caller's generator:
    reproducible per seed, different across seeds."""
    den, s = _Linear(), make_schedule(50, "cosine", "")
    x_T = torch.zeros(3, 16)
    run = lambda seed: sample_loop(s, den.torch_fn(), torch.Generator().manual_seed(seed),  # noqa: E731
                                   (3, 16), noise=x_T)[0]
    torch.testing.assert_close(run(3), run(3), rtol=0, atol=0)
    assert not torch.allclose(run(3), run(4))
