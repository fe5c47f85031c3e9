"""Port parity of the matmul-rate probe (kernel K3): each of the six plain
PyTorch versions in `egohmr_tpu_torch/tools/probe_int8_mma.py` against the
same arithmetic in `jnp`.

The six bodies of tools/probe_int8_mxu.py are closures inside its `main` and
cannot be imported, so they are written out here from that file, line by
line (the lines are cited), as plain `jnp` loops over one chain. The int8
variants must agree exactly, the wrap at 127 included; the bf16 variants to
rtol 1e-5 of the f32 sum; the glue variant to rtol 1e-5 with at most 0.5% of
the elements one quantisation step apart."""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from egohmr_tpu_torch.tools import probe_int8_mma as k3

M, K, N = 96, 64, 64
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _dot(a, b, acc_t):  # probe_int8_mxu.py:72-75
    return jax.lax.dot_general(a, b, dimension_numbers=(((1,), (0,)), ((), ())),
                               preferred_element_type=acc_t, precision="highest")


def _jnp_chain(name, r, x, w, sw=None):
    """One chain of variant `name`: r products, then the max over the rows."""
    if name == "A_bf16":          # :78-89
        acc = jnp.zeros((x.shape[0], w.shape[1]), jnp.float32)
        for i in range(r):
            xi = x + jnp.asarray(i % 2).astype(jnp.bfloat16)          # :84
            acc = acc + _dot(xi, w, jnp.float32)                      # :85
        return jnp.max(acc, axis=0, keepdims=True)                    # :89
    if name == "A1_bf16_bare":    # :92-100
        acc = jnp.zeros((x.shape[0], w.shape[1]), jnp.float32)
        for i in range(r):
            acc = acc + _dot(x, w, jnp.float32)                       # :96
        return jnp.max(acc, axis=0, keepdims=True)
    if name == "B_int8":          # :103-112
        acc = jnp.zeros((x.shape[0], w.shape[1]), jnp.int32)
        for i in range(r):
            xi = (x + jnp.asarray(i % 2).astype(jnp.int8)).astype(jnp.int8)  # :107
            acc = acc + _dot(xi, w, jnp.int32)                        # :108
        return jnp.max(acc, axis=0, keepdims=True)
    if name == "B1_int8_bare":    # :119-127
        acc = jnp.zeros((x.shape[0], w.shape[1]), jnp.int32)
        for i in range(r):
            acc = acc + _dot(x, w, jnp.int32)                         # :123
        return jnp.max(acc, axis=0, keepdims=True)
    if name == "B2_int8_slice":   # :132-140
        m = x.shape[0] // 2
        acc = jnp.zeros((m, w.shape[1]), jnp.int32)
        for i in range(r):
            off = (i % 2) * m                                         # :134
            acc = acc + _dot(x[off:off + m], w, jnp.int32)            # :135-136
        return jnp.max(acc, axis=0, keepdims=True)
    assert name == "C_int8_glue"  # :143-162
    for i in range(r):
        s = jnp.max(jnp.abs(x), axis=1, keepdims=True) / 127.0        # :149
        s = jnp.maximum(s, 1e-8)                                      # :150
        xq = jnp.round(x / s).astype(jnp.int8)                        # :151
        acc = _dot(xq, w, jnp.int32)                                  # :152
        deq = acc.astype(jnp.float32) * s * sw                        # :153
        x = jnp.clip(deq * 0.0625, -2.0, 2.0)                         # :159
    return jnp.max(x, axis=0, keepdims=True)                          # :162


@pytest.fixture
def small(monkeypatch):
    """The probe's operands at a small size, from its own `make_inputs`,
    with a 127 and a -127 planted in the int8 activations."""
    monkeypatch.setattr(k3, "M", M)
    monkeypatch.setattr(k3, "K", K)
    monkeypatch.setattr(k3, "N", N)
    inputs = {k: tuple(t.clone() for t in v) for k, v in k3.make_inputs(seed=1).items()}
    for name in ("B_int8", "B1_int8_bare", "B2_int8_slice"):
        inputs[name][0][3, 5], inputs[name][0][4, 6] = 127, -127
    return inputs


def _to_jnp(t):
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy().copy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy().copy())


def test_inputs_are_made_as_the_original_makes_them(small):
    """x * 30 and w * 30 rounded and clipped to +-127, sw the per-column
    max-abs over 127, xq2 the flipped concatenation (:186-192)."""
    rng = np.random.RandomState(1)
    xf = rng.randn(M, K).astype(np.float32)
    wf = rng.randn(K, N).astype(np.float32)
    fresh = k3.make_inputs(seed=1)
    xq = np.asarray(jnp.round(jnp.clip(jnp.asarray(xf) * 30, -127, 127)).astype(jnp.int8))
    np.testing.assert_array_equal(fresh["B_int8"][0].numpy(), xq)
    np.testing.assert_array_equal(fresh["B2_int8_slice"][0].numpy(),
                                  np.concatenate([xq, xq[::-1]], axis=0))
    np.testing.assert_array_equal(
        fresh["C_int8_glue"][2].numpy(),
        np.asarray(jnp.max(jnp.abs(jnp.asarray(wf)), axis=0, keepdims=True) / 127.0))
    np.testing.assert_array_equal(fresh["A_bf16"][1].float().numpy(),
                                  np.asarray(jnp.asarray(wf).astype(jnp.bfloat16).astype(jnp.float32)))
    assert fresh["A_bf16"][0].dtype == torch.bfloat16 and fresh["C_int8_glue"][1].dtype == torch.int8


@pytest.mark.parametrize("r", [0, 1, 2, 7])
@pytest.mark.parametrize("name", k3.VARIANTS)
def test_plain_version_matches_jnp(small, name, r):
    ops = small[name]
    got = k3.plain(name, r, 3, *ops)
    want = np.asarray(_jnp_chain(name, r, *(_to_jnp(t) for t in ops)))
    assert got.shape == (3, 1, N)
    assert torch.equal(got[0], got[1]) and torch.equal(got[0], got[2])
    got = got[0].numpy()
    if name in ("B_int8", "B1_int8_bare", "B2_int8_slice"):
        assert got.dtype == np.int32 and want.dtype == np.int32
        np.testing.assert_array_equal(got, want)
    elif name.startswith("A"):
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        close = np.isclose(got, want, rtol=1e-5, atol=1e-7)
        assert close.mean() >= 0.995, close.mean()
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=2e-3)


def test_int8_add_wraps_at_127(small):
    """127 + int8(1) is -128 on odd steps, in the plain version as in jnp: a
    saturating add or a widening one would give another sum."""
    x, w = small["B_int8"]
    assert x[3, 5] == 127
    wrapped = k3.plain("B_int8", 2, 1, x, w)[0, 0].numpy().astype(np.int64)
    xi = x.numpy().astype(np.int64)
    wi = w.numpy().astype(np.int64)
    odd = xi + 1
    wide = (xi @ wi + odd @ wi).max(axis=0)
    odd[odd == 128] = -128
    assert np.array_equal(wrapped, (xi @ wi + odd @ wi).max(axis=0))
    assert not np.array_equal(wrapped, wide)


def test_run_checks_its_operands(small):
    x, w = small["B_int8"]
    with pytest.raises(ValueError, match="overflow"):
        k3.run("B_int8", k3.MAX_R_INT8 + 1, 1, x, w)
    with pytest.raises(ValueError, match="unknown variant"):
        k3.run("D_fp8", 1, 1, x, w)
    with pytest.raises(ValueError, match="operands of"):
        k3.run("A_bf16", 1, 1, x, w)
    xf, wq, sw = small["C_int8_glue"]
    with pytest.raises(ValueError, match="K == N"):
        k3.run("C_int8_glue", 1, 1, xf[:, :32], wq[:32], sw)
    # a CPU tensor takes the plain version, and no launch is counted
    before = k3.launches
    assert torch.equal(k3.run("B_int8", 2, 2, x, w), k3.plain("B_int8", 2, 2, x, w))
    assert k3.launches == before


def test_port_probe_main_on_the_cpu(small, capsys):
    """`main(["--cpu", ...])`: one JSON line per variant, then the summary
    with both speed-ups; `--variants` takes names or prefixes."""
    res = k3.main(["--cpu", "--grid", "2", "--r1", "1", "--r2", "3", "--reps", "1"])
    assert set(k3.VARIANTS) <= set(res)
    assert "int8_speedup_pure" in res and "int8_speedup_with_glue" in res
    for name in k3.VARIANTS:
        assert {"us_per_matmul", "tflops", "pct_bf16_peak", "pct_int8_peak",
                "t_r1_ms", "t_r2_ms"} <= set(res[name])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 7 and json.loads(lines[-1]).keys() == res.keys()
    assert lines[0].startswith("A_bf16 {")
    only = k3.main(["--cpu", "--grid", "1", "--r1", "1", "--r2", "2", "--reps", "1",
                    "--variants", "B2_int8_slice,C"])
    assert set(only) == {"B2_int8_slice", "C_int8_glue"}


def test_port_probe_refuses_to_run_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA device"):
        k3.main(["--grid", "1"])


def test_jax_probe_still_runs_in_interpret_mode(monkeypatch):
    """The original probe, untouched, at a small size on the CPU: all six
    Pallas bodies run (`M, K, N` are module globals read at call time)."""
    spec = importlib.util.spec_from_file_location(
        "probe_int8_mxu", os.path.join(ROOT, "tools", "probe_int8_mxu.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(mod, "M", 64)
    monkeypatch.setattr(mod, "K", 128)
    monkeypatch.setattr(mod, "N", 128)
    res = mod.main(["--cpu", "--grid", "1", "--r1", "1", "--r2", "2", "--reps", "1"])
    for name in k3.VARIANTS:  # the same six names in both packages
        assert "error" not in res[name] and "us_per_matmul" in res[name], res[name]


@pytest.mark.parametrize("k", [32, 64, 256])
def test_glue_k_permutation_round_trips(k):
    """`glue_k_order` permutes k within each 32-wide block, and
    `permute_glue_k` moves every column to its place and back."""
    order = k3.glue_k_order(k)
    assert sorted(order.tolist()) == list(range(k))
    assert torch.equal(order // 32, torch.arange(k) // 32)
    wt = torch.tensor(np.random.RandomState(k).randint(-127, 128, (16, k)), dtype=torch.int8)
    wp = k3.permute_glue_k(wt)
    assert not torch.equal(wp, wt) and torch.equal(wp[:, torch.argsort(order)], wt)
    with pytest.raises(ValueError, match="multiple of 32"):
        k3.glue_k_order(k + 16)


def test_glue_k_permutation_keeps_the_int8_product(small):
    """The kernel's product: the activation's columns in `glue_k_order`
    against the permuted w^T equals the plain product, element for element."""
    xf, wq, _ = small["C_int8_glue"]
    xq = torch.round(xf * 30).clamp(-127, 127).to(torch.int8)
    order = k3.glue_k_order(K)
    got = k3._int_product(xq[:, order], k3.permute_glue_k(wq.t().contiguous()).t())
    assert torch.equal(got, k3._int_product(xq, wq))


def test_glue_fragments_take_the_accumulator_columns():
    """The glue kernel's quantise step, index by index: of each 32-wide
    k-block kk, the thread with t = lane % 4 packs its register 2h (row g)
    from its activation values xv[16 kk + 8 h + {0, 1, 4, 5}] (byte 0..3),
    where xv[4 j + r] is column 8 j + 2 t + r % 2 (the accumulator's
    layout); the int8 A fragment puts byte b of register 2h at k = 16 h +
    4 t + b. `glue_k_order` must name that column for that k."""
    order = k3.glue_k_order(256)
    for kk in range(256 // 32):
        for t in range(4):
            for h in range(2):
                for b, idx in enumerate((0, 1, 4, 5)):
                    j, r = divmod(16 * kk + 8 * h + idx, 4)
                    assert int(order[32 * kk + 16 * h + 4 * t + b]) == 8 * j + 2 * t + r % 2
