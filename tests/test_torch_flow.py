"""Port parity of stage 1's conditional Glow flow (`egohmr_tpu_torch.flow`)
against egohmr_tpu.flow, on randomised weights (ActNorm, LU and each
coupling block's last layer drawn away from their identity-like init by
`torch_parity.randomize`), and the nflows key layout of its `state_dict`."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu.flow import glow as jglow
from egohmr_tpu.interop.torch_export import export_conditional_glow as j_export_glow
from egohmr_tpu_torch.flow import (
    Glow,
    GlowConfig,
    coupling_split,
    glow_forward,
    glow_inverse,
    glow_log_prob,
    glow_sample_and_log_prob,
    init_glow_,
    initialize_actnorms,
)
from egohmr_tpu_torch.interop import export_conditional_glow

from .torch_parity import randomize, to_jax, to_np

B, S, CTX = 5, 3, 24
CFG = dict(features=144, hidden_features=32, num_layers=3, num_blocks_per_layer=2,
           context_features=CTX)


@pytest.fixture(scope="module")
def pair():
    """(JAX config, randomised NumPy tree, port Glow loaded strictly from
    the mirror of `export_conditional_glow`, x, context)."""
    jcfg = jglow.GlowConfig(**CFG)
    params = randomize(jglow.init_glow(jax.random.PRNGKey(0), jcfg), seed=3)
    glow = Glow(GlowConfig(**CFG))
    glow.load_state_dict({k: torch.tensor(v) for k, v in
                          export_conditional_glow(params, prefix="").items()}, strict=True)
    rng = np.random.RandomState(1)
    x = rng.randn(B, 144).astype(np.float32) * 0.5
    ctx = rng.randn(B, CTX).astype(np.float32)
    return jcfg, params, glow, x, ctx


@pytest.mark.parametrize("step", [0, 1, 2, 3])
def test_coupling_split_matches_jax(step):
    """Interleaved halves, swapped on odd steps."""
    for got, want in zip(coupling_split(144, step), jglow._coupling_split(144, step)):
        np.testing.assert_array_equal(got, want)
    ident, _ = coupling_split(144, step)
    assert ident[0] == (0 if step % 2 == 0 else 1) and np.all(np.diff(ident) == 2)


def test_export_mirror_matches_jax_key_for_key(pair):
    """The port's NumPy `export_conditional_glow` equals egohmr_tpu's, key
    for key and value for value."""
    _, params, _, _, _ = pair
    want = j_export_glow(to_jax(params))
    got = export_conditional_glow(params)
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == want[k].shape and got[k].dtype == np.float32, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_forward_and_log_prob_match_jax(pair):
    """data -> noise: z at rtol 1e-4, atol 1e-5; log|det| and log_prob at
    rtol 1e-4, atol 1e-3."""
    jcfg, params, glow, x, ctx = pair
    jz, jld = jglow.glow_forward(to_jax(params), jcfg, jnp.asarray(x), jnp.asarray(ctx))
    jlp, _ = jglow.glow_log_prob(to_jax(params), jcfg, jnp.asarray(x), jnp.asarray(ctx))
    with torch.no_grad():
        z, ld = glow_forward(glow, torch.tensor(x), torch.tensor(ctx))
        lp, z2 = glow_log_prob(glow, torch.tensor(x), torch.tensor(ctx))
    np.testing.assert_allclose(to_np(z), np.asarray(jz), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(z2), np.asarray(jz), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(ld), np.asarray(jld), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(to_np(lp), np.asarray(jlp), rtol=1e-4, atol=1e-3)
    assert np.abs(np.asarray(jld)).min() > 1.0  # the randomised steps are far from the identity


def test_inverse_matches_jax_and_undoes_forward(pair):
    """noise -> data at rtol 1e-4, atol 1e-5 against JAX, and inverse after
    forward gives x back with the log|det| negated."""
    jcfg, params, glow, x, ctx = pair
    z = np.random.RandomState(2).randn(B, 144).astype(np.float32)
    jx, jld = jglow.glow_inverse(to_jax(params), jcfg, jnp.asarray(z), jnp.asarray(ctx))
    with torch.no_grad():
        got, ld = glow_inverse(glow, torch.tensor(z), torch.tensor(ctx))
        zz, ld_f = glow_forward(glow, torch.tensor(x), torch.tensor(ctx))
        back, ld_b = glow_inverse(glow, zz, torch.tensor(ctx))
    np.testing.assert_allclose(to_np(got), np.asarray(jx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(ld), np.asarray(jld), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(to_np(back), x, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(ld_b), -to_np(ld_f), rtol=1e-4, atol=1e-3)


def test_sample_and_log_prob_with_given_z_matches_jax(pair):
    """S samples per context row from the same z: samples at rtol 1e-4,
    atol 1e-5, log_prob at rtol 1e-4, atol 1e-3; context rows repeat
    b-major."""
    jcfg, params, glow, _, ctx = pair
    z = np.random.RandomState(4).randn(B, S, 144).astype(np.float32)
    jx, jlp, _ = jglow.glow_sample_and_log_prob(to_jax(params), jcfg, jnp.asarray(ctx),
                                                noise=jnp.asarray(z))
    with torch.no_grad():
        x, lp = glow_sample_and_log_prob(glow, torch.tensor(ctx), torch.tensor(z))
        one, _ = glow_inverse(glow, torch.tensor(z[1]), torch.tensor(ctx[1:2]).expand(S, CTX))
    np.testing.assert_allclose(to_np(x), np.asarray(jx), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(to_np(lp), np.asarray(jlp), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(to_np(x[1]), to_np(one), rtol=1e-5, atol=1e-6)


def test_initialize_actnorms_matches_jax(pair):
    """The data-dependent ActNorm init along the chain, at rtol 1e-5 on the
    scale exp(log_scale) (log_scale itself passes through zero) and on the
    shift, with atol 1e-6 x the largest shift (shifts pass near zero too);
    the first step's output is standardised."""
    jcfg, params, glow, x, ctx = pair
    want = jglow.initialize_actnorms(to_jax(params), jcfg, jnp.asarray(x), jnp.asarray(ctx))
    port = Glow(GlowConfig(**CFG))
    port.load_state_dict(glow.state_dict(), strict=True)
    initialize_actnorms(port, torch.tensor(x), torch.tensor(ctx))
    for k, (an, _, _) in enumerate(port.steps()):
        jan = want["steps"][k]["actnorm"]
        np.testing.assert_allclose(np.exp(to_np(an.log_scale)[0]),
                                   np.exp(np.asarray(jan["log_scale"])), rtol=1e-5,
                                   err_msg=f"step {k}")
        shift = np.asarray(jan["shift"])
        np.testing.assert_allclose(to_np(an.shift)[0], shift, rtol=1e-5,
                                   atol=1e-6 * np.abs(shift).max(), err_msg=f"step {k}")
    an = port.steps()[0][0]
    y = (torch.exp(an.log_scale) * torch.tensor(x) + an.shift).detach()
    np.testing.assert_allclose(to_np(y.mean(0)), 0.0, atol=1e-5)
    np.testing.assert_allclose(to_np(y.std(0)), 1.0, rtol=1e-4)


def test_log_prob_gradients_match_jax(pair):
    """The gradient of sum(log_prob) to every flow weight and to the context:
    rtol 1e-3, atol 1e-3 x the tensor's largest."""
    jcfg, params, glow, x, ctx = pair

    def jloss(p, c):
        return jnp.sum(jglow.glow_log_prob(p, jcfg, jnp.asarray(x), c)[0])

    jg, jgc = jax.grad(jloss, argnums=(0, 1))(to_jax(params), jnp.asarray(ctx))
    want = export_conditional_glow(jax.tree_util.tree_map(np.asarray, jg), prefix="")
    c = torch.tensor(ctx, requires_grad=True)
    glow.zero_grad()
    glow_log_prob(glow, torch.tensor(x), c)[0].sum().backward()
    for k, p in glow.named_parameters():
        w = want[k]
        np.testing.assert_allclose(to_np(p.grad), w, rtol=1e-3, atol=1e-3 * np.abs(w).max(),
                                   err_msg=k)
    np.testing.assert_allclose(to_np(c.grad), np.asarray(jgc), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jgc)).max())


def test_init_is_the_jax_init():
    """`init_glow_` sets ActNorm and LU to the identity, as `init_glow`
    does (the LU's diagonal softplus(d) + 1e-3 = 1), and draws each coupling
    block's last layer within +-1e-3 and its other layers wider."""
    jcfg = jglow.GlowConfig(**CFG)
    jp = jax.tree_util.tree_map(np.asarray, jglow.init_glow(jax.random.PRNGKey(0), jcfg))
    glow = init_glow_(Glow(GlowConfig(**CFG)), torch.Generator().manual_seed(0))
    for (an, lu, coupling), step in zip(glow.steps(), jp["steps"]):
        for name in ("log_scale", "shift"):
            np.testing.assert_array_equal(to_np(getattr(an, name))[0], step["actnorm"][name])
        for name in ("lower_entries", "upper_entries", "unconstrained_upper_diag", "bias"):
            np.testing.assert_allclose(to_np(getattr(lu, name)), step["linear"][name],
                                       rtol=1e-6, err_msg=name)
        for blk in coupling.transform_net.blocks:
            assert blk.linear_layers[1].weight.abs().max() <= 1e-3
            assert blk.linear_layers[0].weight.abs().max() > 1e-2
    from egohmr_tpu_torch.flow.glow import lu_linear_forward

    x = torch.randn(4, 144, generator=torch.Generator().manual_seed(1))
    y, ld = lu_linear_forward(glow.steps()[0][1], x)
    np.testing.assert_allclose(to_np(y), to_np(x), atol=1e-6)
    np.testing.assert_allclose(to_np(ld), 0.0, atol=1e-5)


def test_reference_keys_load_strictly(pair):
    """A reference checkpoint's extra nflows state loads with
    `strict=True`: ActNorm's `initialized`, the coupling's
    `identity_features` and `transform_features`; the port's own
    `state_dict` has none of them,
    and index buffers that disagree with the coupling's split are refused."""
    _, _, glow, _, _ = pair
    sd = dict(glow.state_dict())
    assert not any(k.endswith(("initialized", "_features")) for k in sd)
    ref = dict(sd)
    for k in range(CFG["num_layers"]):
        ident, trans = coupling_split(144, k)
        ref[f"_transform._transforms.{3 * k}.initialized"] = torch.tensor(True)
        ref[f"_transform._transforms.{3 * k + 2}.identity_features"] = torch.tensor(ident)
        ref[f"_transform._transforms.{3 * k + 2}.transform_features"] = torch.tensor(trans)
    fresh = Glow(GlowConfig(**CFG))
    fresh.load_state_dict(ref, strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    bad = dict(ref)
    bad["_transform._transforms.2.identity_features"] = torch.tensor(coupling_split(144, 1)[0])
    with pytest.raises(RuntimeError, match="coupling split"):
        Glow(GlowConfig(**CFG)).load_state_dict(bad, strict=True)
    with pytest.raises(RuntimeError, match="Unexpected"):
        Glow(GlowConfig(**CFG)).load_state_dict({**sd, "_transform.extra": torch.zeros(1)})
