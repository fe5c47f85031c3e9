"""The graph-convolution epilogue (`egohmr_tpu_torch/nn/gconv_epilogue.py`)
on the CPU: its plain statement of the kernel's arithmetic against the GCN's
plain path, its constants against what the plain path builds on every call,
and where `nn/gcn.py` sends a graph convolution. The kernel itself runs in
`tests/test_torch_gpu.py` on the card."""
import copy
import math

import pytest
import torch

from egohmr_tpu_torch.models.egohmr import _adjacency
from egohmr_tpu_torch.nn import cast_params_bf16, modulated_gcn_forward, modulated_gcn_forward_tp
from egohmr_tpu_torch.nn import gcn as gcn_module
from egohmr_tpu_torch.nn import gconv_epilogue as epilogue
from egohmr_tpu_torch.nn.gcn import GraphConv, ModulatedGCN, ModulatedGraphConv, graph_conv
from egohmr_tpu_torch.nn.gcn import modulated_gconv
from egohmr_tpu_torch.parallel import gcn_tp_specs, make_dp_tp_grid, place_params

ADJ = _adjacency(torch.device("cpu"))
IN = 32  # the products' input width: small, so the bf16 products stay cheap here


def _randomize(module: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Every parameter drawn at random (W at 1/sqrt(in)), BatchNorms with
    random statistics around 1 and 0."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in module.named_parameters():
            scale = t.shape[-2] ** -0.5 if name.endswith("W") else 0.5
            t.copy_(torch.randn(t.shape, generator=g) * scale)
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm1d):
                c = m.num_features
                m.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
                m.bias.copy_(0.1 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.3 * torch.randn(c, generator=g))
                m.running_var.copy_(1 + torch.rand(c, generator=g))
    return module.eval()


def _bf16_ulp(x: torch.Tensor) -> float:
    """One bf16 ulp at the magnitude of x's largest entry."""
    return 2.0 ** (math.floor(math.log2(x.abs().max().item())) - 7)


def _f32_conv(c, h0, h1, residual):
    """The convolution in f32 arithmetic from the same bf16 inputs, not
    rounded at the end."""
    m, vec = c.m.float(), c.vec.float()
    z = c.diag[:, None] * (m * h0.float()) + torch.einsum("jk,nkd->njd", c.off, m * h1.float())
    z = z + vec[0]
    if vec.shape[0] == 3:
        z = torch.relu(vec[1] * z + vec[2])
    return z if residual is None else z + residual.float()


# ------------------------------------------------- (a) the kernel's arithmetic
@pytest.mark.parametrize("D", [6, 1024])
@pytest.mark.parametrize("batch", [1, 3, 64])
@pytest.mark.parametrize("stage", ["bn_relu", "residual", "output"])
def test_statement_agrees_with_the_plain_path(stage, batch, D):
    """The plain statement of the kernel's arithmetic (f32 from the bf16
    inputs, one rounding) against today's bf16 `graph_conv` (BatchNorm and
    ReLU, with and without the residual add) and the output convolution
    (those stages off): within 2 bf16 ulps of the output's largest
    magnitude, and no further from the f32 evaluation than the plain bf16
    path is."""
    seed = 100 * batch + D
    g = torch.Generator().manual_seed(seed)
    out_conv = stage == "output"
    p = _randomize(ModulatedGraphConv(IN, D) if out_conv else GraphConv(IN, D), seed)
    p = cast_params_bf16(p)
    gc = p if out_conv else p.gconv
    x = torch.randn(batch, 24, IN, generator=g).bfloat16()
    residual = (torch.relu(torch.randn(batch, 24, D, generator=g)).bfloat16()
                if stage == "residual" else None)
    with torch.no_grad():
        plain = (modulated_gconv(p, ADJ, x) if out_conv
                 else graph_conv(p, ADJ, x, residual=residual))
        c = epilogue.build_constants(gc, ADJ, None if out_conv else p.bn)
        h0, h1 = x @ gc.W[0], x @ gc.W[1]
        got = epilogue.gconv_epilogue_reference(c, h0, h1, residual)
        f32 = _f32_conv(c, h0, h1, residual)
    assert got.dtype == plain.dtype == torch.bfloat16 and got.shape == plain.shape
    assert (got.float() - plain.float()).abs().max().item() <= 2 * _bf16_ulp(plain.float())
    assert (got.float() - f32).abs().max() <= (plain.float() - f32).abs().max()


# ----------------------------------------------------------- (b) constants
@pytest.mark.parametrize("with_bn", [True, False], ids=["batchnorm", "output"])
def test_constants_are_what_the_plain_path_builds(with_bn):
    """`a`'s diagonal and off-diagonal parts, M, the bias and BatchNorm's
    scale and shift are bit for bit what `modulated_gconv_mix` and
    `batchnorm_eval` compute on every call."""
    D = 64
    p = cast_params_bf16(_randomize(GraphConv(IN, D), 7))
    c = epilogue.build_constants(p.gconv, ADJ, p.bn if with_bn else None)
    # modulated_gconv_mix's adjacency, as it builds it
    a = ADJ.float() + p.gconv.adj2.float()
    a = ((a.T + a) / 2).to(torch.bfloat16)
    eye = torch.eye(24, dtype=torch.bfloat16)
    assert c.diag.dtype == c.off.dtype == torch.float32
    assert torch.equal(torch.diag(c.diag), (a * eye).float())
    assert torch.equal(c.off, (a * (1 - eye)).float())
    assert torch.equal(c.m, p.gconv.M) and torch.equal(c.vec[0], p.gconv.bias)
    assert c.vec.shape == ((3, D) if with_bn else (1, D))
    if with_bn:  # batchnorm_eval's fold, as it computes it
        bn = p.bn
        inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
        shift = bn.bias - bn.running_mean * inv
        assert torch.equal(c.vec[1], inv.to(torch.bfloat16))
        assert torch.equal(c.vec[2], shift.to(torch.bfloat16))


def test_constants_are_built_once_and_again_after_a_change():
    """Calls on one convolution build its constants once; an in-place
    update of a parameter or a running statistic builds them anew, with the
    new values."""
    p = cast_params_bf16(_randomize(GraphConv(IN, 16), 8))
    c1 = epilogue.epilogue_constants(p.gconv, ADJ, p.bn)
    c2 = epilogue.epilogue_constants(p.gconv, ADJ, p.bn)
    assert c1 is c2
    with torch.no_grad():
        p.gconv.adj2.mul_(2)
    c3 = epilogue.epilogue_constants(p.gconv, ADJ, p.bn)
    assert c3 is not c1 and not torch.equal(c1.off, c3.off)
    assert epilogue.epilogue_constants(p.gconv, ADJ, p.bn) is c3
    with torch.no_grad():
        p.bn.running_var.add_(1)
    c4 = epilogue.epilogue_constants(p.gconv, ADJ, p.bn)
    assert c4 is not c3 and not torch.equal(c3.vec, c4.vec)
    assert torch.equal(c4.vec, epilogue.build_constants(p.gconv, ADJ, p.bn).vec)


def test_the_kernels_wrapper_refuses_cpu_tensors():
    """The wrapper launches the kernel or raises: CPU tensors are refused
    before the library is loaded."""
    p = cast_params_bf16(_randomize(GraphConv(IN, 16), 10))
    c = epilogue.build_constants(p.gconv, ADJ, p.bn)
    h = torch.zeros(2, 24, 16, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        epilogue.gconv_epilogue(c, h, h)


# -------------------------------------------------------------- (c) dispatch
def _gcn(bf16: bool = True) -> ModulatedGCN:
    gcn = _randomize(ModulatedGCN(IN, hid_dim=16, num_layers=2), 9)
    return cast_params_bf16(gcn) if bf16 else gcn


@pytest.fixture
def recorder(monkeypatch):
    """The kernel's wrapper replaced by a stand-in that records each call
    and answers with the plain statement."""
    calls = []

    def stand_in(c, h0, h1, residual=None):
        calls.append((tuple(h0.shape), residual is not None))
        return epilogue.gconv_epilogue_reference(c, h0, h1, residual)

    monkeypatch.setattr(epilogue, "gconv_epilogue", stand_in)
    return calls


def _take_cpu_as_the_card(monkeypatch):
    """`nn/gcn.py`'s dispatch with CPU tensors taken as the card's: every
    other condition of `_fused` holds as it is."""
    monkeypatch.setattr(gcn_module, "_fused", gcn_module._kernel_arithmetic_holds)


@pytest.mark.parametrize("case", ["cpu", "train", "grad", "f32", "tp"])
def test_only_bf16_inference_on_the_kernels_device_reaches_the_kernel(
        case, recorder, monkeypatch):
    """CPU tensors never reach the wrapper; with the CPU standing in for
    the card, training (batch statistics), a grad-enabled call on weights
    that require grad, f32 and the tensor-parallel split don't either, and
    their outputs are the plain path's bit for bit."""
    gcn = _gcn(bf16=case != "f32")
    dt = torch.float32 if case == "f32" else torch.bfloat16
    x = torch.randn(2, 24, IN, generator=torch.Generator().manual_seed(1)).to(dt)
    with torch.no_grad():
        plain = modulated_gcn_forward(copy.deepcopy(gcn), ADJ, x, train=case == "train")
    if case != "cpu":
        _take_cpu_as_the_card(monkeypatch)
    if case == "tp":
        grid = make_dp_tp_grid(1, 2, ["cpu", "cpu"])
        placed = place_params(grid, gcn, gcn_tp_specs(gcn))[0]
        modulated_gcn_forward_tp(placed, ADJ, x)
    else:
        with torch.set_grad_enabled(case == "grad"):
            got = modulated_gcn_forward(gcn, ADJ, x, train=case == "train")
        assert torch.equal(got, plain)
    assert recorder == []


def test_bf16_inference_takes_the_fused_epilogue(recorder, monkeypatch):
    """With the CPU standing in for the card, a bf16 forward under no_grad
    sends every BatchNorm'd graph convolution through the wrapper (the
    input one, then two a residual block, the second with the residual
    stream) and keeps the output convolution plain; the result is the plain
    path's within its bf16 rounding, and a forward with `input_h` equals
    one from x."""
    gcn = _gcn()
    x = torch.randn(3, 24, IN, generator=torch.Generator().manual_seed(2)).bfloat16()
    W = gcn.gconv_input[0].gconv.W
    with torch.no_grad():
        plain = modulated_gcn_forward(gcn, ADJ, x)
        assert recorder == []
        _take_cpu_as_the_card(monkeypatch)
        got = modulated_gcn_forward(gcn, ADJ, x)
        hoisted = modulated_gcn_forward(gcn, ADJ, None, input_h=(x @ W[0], x @ W[1]))
    n = 1 + 2 * len(gcn.gconv_layers)
    assert len(recorder) == 2 * n
    assert [r for _, r in recorder[:n]] == [False] + [False, True] * len(gcn.gconv_layers)
    assert torch.equal(got, hoisted) and got.shape == plain.shape == (3, 24, 6)
    assert (got.float() - plain.float()).abs().max().item() <= 0.05 * plain.float().abs().max()
