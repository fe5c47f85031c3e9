"""The ResNet epilogue (`egohmr_tpu_torch/nn/resnet_epilogue.py`) on the
CPU: its plain statement of the kernel's arithmetic against ResNet's plain
bf16 path, its constants against what `batchnorm_eval` builds on every
call, the wrapper's refusals, and where `nn/resnet.py` sends a forward. The
kernel itself runs in `tests/test_torch_gpu.py` on the card."""
import copy
import math

import pytest
import torch
import torch.nn.functional as F

from egohmr_tpu_torch.nn import cast_params_bf16, resnet_forward
from egohmr_tpu_torch.nn import resnet as resnet_module
from egohmr_tpu_torch.nn import resnet_epilogue as epilogue
from egohmr_tpu_torch.nn.core import batchnorm_eval
from egohmr_tpu_torch.nn.resnet import ResNet

CL = torch.channels_last


def _randomize_bn(bn: torch.nn.BatchNorm2d, g: torch.Generator) -> torch.nn.BatchNorm2d:
    """Random affine parameters and running statistics around 1 and 0."""
    c = bn.num_features
    with torch.no_grad():
        bn.weight.copy_(1 + 0.1 * torch.randn(c, generator=g))
        bn.bias.copy_(0.1 * torch.randn(c, generator=g))
        bn.running_mean.copy_(0.3 * torch.randn(c, generator=g))
        bn.running_var.copy_(1 + torch.rand(c, generator=g))
    return bn.eval()


def _act(shape, g, relu=False):
    x = torch.randn(shape, generator=g)
    return (torch.relu(x) if relu else x).bfloat16().contiguous(memory_format=CL)


def _resnet(layers: int, seed: int, bf16: bool = True) -> ResNet:
    """A ResNet with PyTorch's initial weights and random BatchNorms, eval."""
    torch.manual_seed(seed)
    model = ResNet(layers).eval()
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            _randomize_bn(m, g)
    return cast_params_bf16(model) if bf16 else model


# the pass's forms, as ResNet-50 has them: (channels, H, residual)
FORMS = {"stem": (64, 28, None), "conv1_conv2": (128, 14, None),
         "conv3_identity": (256, 14, "identity"), "conv3_downsample": (512, 7, "downsample")}


# ------------------------------------------------- (a) the kernel's arithmetic
@pytest.mark.parametrize("batch", [1, 5])
@pytest.mark.parametrize("form", list(FORMS))
def test_statement_agrees_with_the_plain_path(form, batch):
    """The plain statement of the kernel's arithmetic (f32 from the bf16
    inputs, one rounding) against today's bf16 glue after a convolution
    (`batchnorm_eval`, the residual, through the downsample BatchNorm where
    there is one, and ReLU): within one bf16 ulp of the output's largest
    magnitude, and no further from the exact result than the plain path is.
    (A bar of one ulp at each output's own magnitude cannot hold: the plain
    path rounds BatchNorm's product before its shift is added, and where
    the two cancel, that rounding is of the terms' size, not the output's.)"""
    C, H, kind = FORMS[form]
    g = torch.Generator().manual_seed(10 * batch + C)
    bn, bn_ds = (_randomize_bn(torch.nn.BatchNorm2d(C), g) for _ in range(2))
    a = _act((batch, C, H, H), g)
    with torch.no_grad():
        plain = batchnorm_eval(bn, a, 1)
        c = epilogue.build_constants(bn)
        exact = c[0].double().view(-1, 1, 1) * a.double() + c[1].double().view(-1, 1, 1)
        if kind == "identity":
            x = _act((batch, C, H, H), g, relu=True)
            plain, got = plain + x, epilogue.resnet_epilogue_reference(a, c, x)
            exact = exact + x.double()
        elif kind == "downsample":
            b = _act((batch, C, H, H), g)
            c_ds = epilogue.build_constants(bn_ds)
            plain = plain + batchnorm_eval(bn_ds, b, 1)
            got = epilogue.resnet_epilogue_reference(a, c, b, c_ds)
            exact = exact + c_ds[0].double().view(-1, 1, 1) * b.double() + c_ds[1].double().view(
                -1, 1, 1)
        else:
            got = epilogue.resnet_epilogue_reference(a, c)
        plain, exact = torch.relu(plain), torch.relu(exact)
    assert got.dtype == plain.dtype == torch.bfloat16 and got.shape == plain.shape
    assert got.is_contiguous(memory_format=CL)
    largest = plain.float().abs().max().item()
    ulp = 2.0 ** (math.floor(math.log2(largest)) - 7)
    assert (got.float() - plain.float()).abs().max().item() <= ulp
    assert (got.double() - exact).abs().max() <= (plain.double() - exact).abs().max()


# ----------------------------------------------------------- (b) constants
def test_constants_are_what_batchnorm_eval_folds():
    """The scale and shift are bit for bit `batchnorm_eval_fold`'s, as
    `batchnorm_eval` computes them on every call for bf16 activations."""
    bn = _randomize_bn(torch.nn.BatchNorm2d(64), torch.Generator().manual_seed(1))
    c = epilogue.build_constants(bn)
    inv = torch.rsqrt(bn.running_var + bn.eps) * bn.weight
    assert c.shape == (2, 64) and c.dtype == torch.bfloat16 and c.is_contiguous()
    assert torch.equal(c[0], inv.to(torch.bfloat16))
    assert torch.equal(c[1], (bn.bias - bn.running_mean * inv).to(torch.bfloat16))
    a = _act((2, 64, 3, 3), torch.Generator().manual_seed(2))
    # the plain path's fold, reached through batchnorm_eval
    assert torch.equal(batchnorm_eval(bn, a, 1),
                       a * c[0].view(-1, 1, 1) + c[1].view(-1, 1, 1))


def test_constants_are_built_once_and_again_after_a_change():
    """Calls on one BatchNorm build its constants once; an in-place update
    of a parameter or a running statistic, or a `load_state_dict`, builds
    them anew, with the new values."""
    g = torch.Generator().manual_seed(3)
    bn = _randomize_bn(torch.nn.BatchNorm2d(32), g)
    c1 = epilogue.bn_constants(bn)
    assert epilogue.bn_constants(bn) is c1
    with torch.no_grad():
        bn.weight.mul_(2)
    c2 = epilogue.bn_constants(bn)
    assert c2 is not c1 and not torch.equal(c1[0], c2[0])
    assert epilogue.bn_constants(bn) is c2
    with torch.no_grad():
        bn.running_mean.add_(1)
    c3 = epilogue.bn_constants(bn)
    assert c3 is not c2 and torch.equal(c3[0], c2[0]) and not torch.equal(c3[1], c2[1])
    bn.load_state_dict(_randomize_bn(torch.nn.BatchNorm2d(32), g).state_dict())
    c4 = epilogue.bn_constants(bn)
    assert c4 is not c3 and torch.equal(c4, epilogue.build_constants(bn))
    assert not torch.equal(c4, c3)


# ------------------------------------------------------- (c) the wrapper
def test_the_kernels_wrapper_refuses_what_it_cannot_take():
    """The wrapper launches the kernel or raises, before the library is
    loaded: CPU tensors, NCHW-contiguous memory, a misaligned start, a
    channel count the kernel's width does not divide, another dtype, a
    residual of another shape or in the memory it writes, and malformed
    constants."""
    g = torch.Generator().manual_seed(4)
    bn = _randomize_bn(torch.nn.BatchNorm2d(16), g)
    c = epilogue.build_constants(bn)
    a = _act((2, 16, 5, 5), g)
    with pytest.raises(ValueError, match="CUDA tensors"):
        epilogue.resnet_epilogue(a, c)
    with pytest.raises(ValueError, match="channels_last"):
        epilogue.resnet_epilogue(a.contiguous(), c)
    with pytest.raises(ValueError, match="channels_last"):
        epilogue.resnet_epilogue(a, c, a.contiguous())
    with pytest.raises(ValueError, match="aligned"):
        flat = torch.zeros(2 * 5 * 5 * 16 + 1, dtype=torch.bfloat16)[1:]
        epilogue.resnet_epilogue(flat.view(2, 5, 5, 16).permute(0, 3, 1, 2), c)
    with pytest.raises(ValueError, match="multiples of 8"):
        epilogue.resnet_epilogue(a[:, :12], c[:, :12].contiguous())
    with pytest.raises(ValueError, match="bf16"):
        epilogue.resnet_epilogue(a.float(), c)
    with pytest.raises(ValueError, match="channels_last"):
        epilogue.resnet_epilogue(a, c, a[:1])
    with pytest.raises(ValueError, match="constants"):
        epilogue.resnet_epilogue(a, c[:1])
    with pytest.raises(ValueError, match="overlaps"):
        epilogue.resnet_epilogue(a, c, a)
    with pytest.raises(ValueError, match="needs the residual"):
        epilogue.resnet_epilogue(a, c, None, c)


# -------------------------------------------------------------- (d) dispatch
@pytest.fixture
def recorder(monkeypatch):
    """The kernel's wrapper replaced by a stand-in that records each call's
    form and answers with the plain statement, written into the
    convolution's output as the kernel writes it."""
    calls = []

    def stand_in(a, c, residual=None, c_res=None):
        calls.append("stem_or_inner" if residual is None
                     else "identity" if c_res is None else "downsample")
        return a.copy_(epilogue.resnet_epilogue_reference(a, c, residual, c_res))

    monkeypatch.setattr(epilogue, "resnet_epilogue", stand_in)
    return calls


def _take_cpu_as_the_card(monkeypatch):
    """`nn/resnet.py`'s dispatch with CPU tensors taken as the card's: every
    other condition of `_fused` holds as it is."""
    monkeypatch.setattr(resnet_module, "_fused", resnet_module._kernel_arithmetic_holds)


IMG = 32  # pixels a side: every stage keeps at least one row


@pytest.mark.parametrize("case", ["cpu", "train", "grad", "f32", "bf16_bn"])
def test_only_bf16_inference_on_the_kernels_device_reaches_the_kernel(
        case, recorder, monkeypatch):
    """CPU tensors never reach the wrapper; with the CPU standing in for
    the card, training (batch statistics), a grad-enabled call on weights
    that require grad, f32, and BatchNorms cast to bf16 (whose plain path
    does not fold) don't either, and their outputs are the plain path's bit
    for bit."""
    model = _resnet(18, seed=5, bf16=case != "f32")
    if case == "bf16_bn":
        model = model.bfloat16()
    dt = torch.float32 if case == "f32" else torch.bfloat16
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(6)).to(dt)
    with torch.no_grad():
        plain = resnet_forward(copy.deepcopy(model), x, train=case == "train")
    if case != "cpu":
        _take_cpu_as_the_card(monkeypatch)
    with torch.set_grad_enabled(case == "grad"):
        got = resnet_forward(model, x, train=case == "train")
    assert torch.equal(got, plain)
    assert recorder == []


@pytest.mark.parametrize("layers,want", [(50, 49), (18, 17)])
def test_bf16_inference_takes_the_fused_epilogue(layers, want, recorder, monkeypatch):
    """With the CPU standing in for the card, a bf16 forward under no_grad
    sends every convolution's glue through the wrapper: the stem, each
    block's inner convolutions, and its last one with the identity residual
    or, in a stage's first block, with the downsample branch merged in
    (ResNet-50: 1 + 16 x 3 = 49; ResNet-18: 1 + 8 x 2 = 17). The features
    are the plain path's within their bf16 rounding."""
    model = _resnet(layers, seed=7)
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(8)).bfloat16()
    with torch.no_grad():
        plain = resnet_forward(model, x)
        assert recorder == []
        _take_cpu_as_the_card(monkeypatch)
        got = resnet_forward(model, x)
    blocks = 16 if layers == 50 else 8
    ds = 4 if layers == 50 else 3  # ResNet-18's first stage keeps its width
    assert len(recorder) == want
    assert recorder.count("downsample") == ds
    assert recorder.count("identity") == blocks - ds
    assert got.shape == plain.shape == (2, 2048 if layers == 50 else 512)
    assert (got.float() - plain.float()).abs().max().item() <= 0.05 * plain.float().abs().max()


# ----------------------------------------------- (e) the plain path unchanged
def _parent_forward(model: ResNet, x_nhwc: torch.Tensor) -> torch.Tensor:
    """ResNet's eval forward as the port ran it before the epilogue:
    convolutions, BatchNorm on its running statistics (folded to a scale
    and shift of the activation dtype when that is below f32), ReLU and the
    residual add, each as its own op."""
    def bn(m, y):
        if y.dtype != torch.float32:
            inv = torch.rsqrt(m.running_var + m.eps) * m.weight
            return (y * inv.to(y.dtype).view(-1, 1, 1)
                    + (m.bias - m.running_mean * inv).to(y.dtype).view(-1, 1, 1))
        inv = torch.rsqrt(m.running_var + m.eps) * m.weight
        return (y - m.running_mean.view(-1, 1, 1)) * inv.view(-1, 1, 1) + m.bias.view(-1, 1, 1)

    out = F.conv2d(x_nhwc.permute(0, 3, 1, 2), model.conv1.weight, stride=2, padding=3)
    out = F.max_pool2d(torch.relu(bn(model.bn1, out)), 3, 2, 1)
    for li in range(1, 5):
        for b, blk in enumerate(getattr(model, f"layer{li}")):
            s = (2 if li > 1 else 1) if b == 0 else 1
            x = out
            out = torch.relu(bn(blk.bn1, F.conv2d(x, blk.conv1.weight)))
            out = torch.relu(bn(blk.bn2, F.conv2d(out, blk.conv2.weight, stride=s, padding=1)))
            out = bn(blk.bn3, F.conv2d(out, blk.conv3.weight))
            if blk.downsample is not None:
                x = bn(blk.downsample[1], F.conv2d(x, blk.downsample[0].weight, stride=s))
            out = torch.relu(out + x)
    return out.mean(dim=(2, 3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_forward_is_the_plain_path_bit_for_bit(dtype):
    """`resnet_forward` on the CPU, eval, equals the plain path's ops as
    the port ran them before the epilogue, bit for bit, in f32 and in bf16
    (the kernel's path is for CUDA tensors only)."""
    bf16 = dtype == "bfloat16"
    model = _resnet(50, seed=9, bf16=bf16)
    x = torch.randn(2, IMG, IMG, 3, generator=torch.Generator().manual_seed(10))
    x = x.to(getattr(torch, dtype))
    with torch.no_grad():
        got = resnet_forward(model, x)
        want = _parent_forward(model, x)
    assert got.dtype == x.dtype and torch.equal(got, want)
