"""PoseNet ResNet50's fused stem (`ops/stem.py`, `csrc/stem.cu`): the conv
7x7/2 + bias, ReLU and max pool 3x3/2 in one kernel.

On the CPU: the plain version against `resnet50.run_stem`'s eager route
(`_conv` + `F.max_pool2d`), which the CPU and float32 trunks keep; the
route that sends only bf16 inputs on the card to the op, and what it hands
the op from uncast parameters and an NCHW input; the wrapper's
refusals; the trunk through the kernel's route (here its plain version)
counting 53 convs; and the kernel's symbol name, which the benchmark's
`yardstick.KINDS` has to file with the convs.

Marked `cuda`: the kernel against the plain version on the card, and its
launches in ResNet50 and m101 forwards and in a ResNet50 pipeline call.
"""

import math
import os
import re
import types

import pytest
import torch

from benchmarks import yardstick
from posenet_tpu_torch import PoseNetPipeline
from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.models import mobilenet_v1, resnet50
from posenet_tpu_torch.models.model_factory import ResNet50
from posenet_tpu_torch.ops import stem

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(REPO, 'posenet_tpu_torch', 'csrc', 'stem.cu')
SHAPES = [(b, h, w) for h, w in ((513, 513), (33, 33), (17, 49), (7, 7)) for b in (1, 3)]


@pytest.fixture
def cuda():
    """The card, with TF32 off; skips without one."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.fixture(autouse=True)
def few_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def _inputs(seed, b, h, w, device='cpu'):
    """Frames as `normalize` writes them (uint8 RGB plus the ImageNet mean,
    bf16, NHWC), and the stem's parameters as `cast_params` keeps them
    (bf16, the kernel in channels_last memory), He-scaled."""
    g = torch.Generator().manual_seed(seed)
    frames = torch.randint(0, 256, (b, h, w, 3), dtype=torch.uint8, generator=g)
    mean = torch.tensor(resnet50.IMAGENET_MEAN)
    x = resnet50.normalize(frames, {'mean': mean}, torch.bfloat16)
    wt = torch.randn((64, 3, 7, 7), generator=g) * math.sqrt(2 / 147)
    bias = torch.randn((64,), generator=g)
    return (x.to(device), wt.to(device, torch.bfloat16).contiguous(memory_format=torch.channels_last),
            bias.to(device, torch.bfloat16))


def assert_within_one_bf16_ulp(got, ref):
    """Each element within one bf16 ulp of `ref`, or within 2^-16 of the
    output's scale max(1, max |ref|): the kernel sums the same float32
    products in another order, and near zero (where a ReLU output can lie
    after cancelling terms of ~10) the float32 sums' rounding, not the
    bf16 ulp, sets the gap."""
    got, ref = got.float(), ref.float()
    ulp = torch.exp2(torch.floor(torch.log2(ref.abs().clamp_min(1e-30))) - 7)
    floor = 2.0 ** -16 * max(1.0, float(ref.abs().max()))
    excess = (got - ref).abs() - ulp.clamp_min(floor)
    assert float(excess.max()) <= 0, f'{int((excess > 0).sum())} elements beyond one bf16 ulp'


@pytest.mark.parametrize('b,h,w', SHAPES)
def test_plain_stem_equals_the_eager_stem(b, h, w):
    """Bit for bit against the eager stem run in float32 on the same bf16
    values, rounded once to bf16 (the same float32 conv, so the same sums;
    rounding is monotone, so pooling before or after it agrees). Against
    the CPU's bf16 eager stem, whose conv sums the same products in
    oneDNN's bf16 order: within one bf16 ulp, bitwise but where a float32
    sum's order moves a rounding (measured 5e-5 of the conv outputs at
    513x513)."""
    x, wt, bias = _inputs(b * 1000 + h, b, h, w)
    plain = stem.stem_reference(x, wt, bias)
    assert plain.shape == (b, 64, math.ceil(h / 4), math.ceil(w / 4))
    assert plain.dtype == torch.bfloat16
    assert plain.is_contiguous(memory_format=torch.channels_last)
    eager32 = resnet50.run_stem(x.float(), {'w': wt.float(), 'b': bias.float()})
    assert torch.equal(plain, eager32.to(torch.bfloat16))
    eager16 = resnet50.run_stem(x, {'w': wt, 'b': bias})
    assert eager16.dtype == torch.bfloat16 and eager16.shape == plain.shape
    assert_within_one_bf16_ulp(eager16, plain)
    assert float((eager16 == plain).float().mean()) >= 0.999


def test_only_bf16_on_the_card_takes_the_kernel(monkeypatch):
    """The CPU trunks, bf16 and float32, never reach the wrapper (nor the
    op behind it); the predicate holds for a bf16 input on the card alone."""
    def refuse(*_):
        raise AssertionError('the stem kernel was reached')
    monkeypatch.setattr(stem, 'stem', refuse)
    params = resnet50.init_params(torch.Generator().manual_seed(1), _cfg(torch.float32))
    x = _inputs(2, 1, 65, 65)[0]
    before = stem.launches
    for dtype in (torch.bfloat16, torch.float32):
        cp = resnet50.cast_params(params, dtype, 'cpu')
        with torch.no_grad():
            feats = resnet50.run_trunk(cp, x, _cfg(dtype))
        assert feats.shape == (1, resnet50.FEATURES, 5, 5) and feats.dtype == dtype
    assert stem.launches == before
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    assert resnet50.uses_stem_kernel(card)
    assert not resnet50.uses_stem_kernel(types.SimpleNamespace(is_cuda=True,
                                                               dtype=torch.float32))
    assert not resnet50.uses_stem_kernel(x)


def _cfg(dtype):
    return ModelConfig(output_stride=16, compute_dtype=dtype, architecture='resnet50')


@pytest.mark.parametrize('case', ['x_f32', 'x_nchw_memory', 'w_oihw_memory', 'x_4_channels',
                                  'h_6', 'w_5', 'w_f32', 'b_f32', 'w_5x5', 'meta_device'])
def test_wrapper_refuses(case):
    x, wt, bias = _inputs(3, 2, 9, 11)
    if case == 'x_f32':
        x = x.float()
    elif case == 'x_nchw_memory':   # NHWC shape over NCHW memory
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif case == 'w_oihw_memory':
        wt = wt.contiguous()
    elif case == 'x_4_channels':
        x = torch.cat([x, x[..., :1]], dim=-1)
    elif case == 'h_6':
        x = x[:, :6].contiguous()
    elif case == 'w_5':
        x = x[:, :, :5].contiguous()
    elif case == 'w_f32':
        wt = wt.float()
    elif case == 'b_f32':
        bias = bias.float()
    elif case == 'w_5x5':
        wt = wt[:, :, 1:6, 1:6].contiguous(memory_format=torch.channels_last)
    elif case == 'meta_device':
        x, wt, bias = (t.to('meta') for t in (x, wt, bias))
    with pytest.raises(ValueError):
        stem.stem(x, wt, bias)


def test_the_kernel_route_counts_53_convs_and_matches_the_eager_trunk(monkeypatch):
    """The bf16 trunk with the stem routed as on the card (the wrapper takes
    its plain version on the CPU): 53 convs a forward, the wrapper called
    once with the normalized NHWC input, and features within the bf16
    bar of the eager trunk's (the two stems differ by at most one bf16
    ulp, and the 52 convs after carry that on)."""
    params = resnet50.init_params(torch.Generator().manual_seed(4), _cfg(torch.float32))
    cp = resnet50.cast_params(params, torch.bfloat16, 'cpu')
    x = _inputs(5, 2, 65, 65)[0]
    with torch.no_grad():
        eager = resnet50.run_trunk(cp, x, _cfg(torch.bfloat16))
        calls = []
        plain = stem.stem

        def counted(*args):
            calls.append(args)
            return plain(*args)
        monkeypatch.setattr(stem, 'stem', counted)
        monkeypatch.setattr(resnet50, 'uses_stem_kernel', lambda t: t.dtype == torch.bfloat16)
        before = resnet50.convs
        routed = resnet50.run_trunk(cp, x, _cfg(torch.bfloat16))
    assert resnet50.convs - before == 53
    assert len(calls) == 1 and calls[0][0] is x
    assert routed.shape == eager.shape and routed.dtype == torch.bfloat16
    assert routed.is_contiguous(memory_format=torch.channels_last)
    rms = eager.float().pow(2).mean().sqrt()
    gap = (routed.float() - eager.float()).pow(2).mean().sqrt() / rms
    assert gap <= 2 * math.sqrt(53) * 2 ** -9, float(gap)


def test_uncast_parameters_and_an_nchw_input_reach_the_op_as_it_takes_them(monkeypatch):
    """`ResNet50(compute_dtype=bf16)` called on an NCHW batch, routed as on
    the card: `init_params`'s float32 kernel in NCHW memory and the
    permuted input reach the wrapper as its checks take them (bf16, the
    kernel channels_last, the input NHWC-contiguous), and the heads equal
    the eager route's within the bf16 bar."""
    model = ResNet50(16, compute_dtype=torch.bfloat16, device='cpu')
    x = _inputs(9, 1, 65, 65)[0].float().permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        eager = model(x)
        calls = []
        plain = stem.stem

        def counted(*args):
            calls.append(args)
            return plain(*args)
        monkeypatch.setattr(stem, 'stem', counted)
        monkeypatch.setattr(resnet50, 'uses_stem_kernel', lambda t: t.dtype == torch.bfloat16)
        routed = model(x)
    (args,) = calls
    assert args[0].is_contiguous() and args[0].dtype == torch.bfloat16
    assert args[1].is_contiguous(memory_format=torch.channels_last)
    assert args[1].dtype == args[2].dtype == torch.bfloat16
    for a, b in zip(routed, eager):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 0.05 * max(1.0, float(b.abs().max()))


def test_the_kernel_name_files_with_the_convs():
    """The benchmark's `yardstick.kind_of` files the kernel as 'cuDNN
    convs', where `r50_conv_roofline.offline` counts its time beside the
    stem conv's bound: the name holds 'conv' and no word of a kind matched
    before it."""
    names = re.findall(r'__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(',
                       open(SOURCE).read())
    assert names == ['stem_conv_relu_maxpool_kernel']
    traced = f'void (anonymous namespace)::{names[0]}(unsigned short const*, ...)'
    assert yardstick.kind_of({'name': traced, 'cat': 'kernel'}) == 'cuDNN convs'


@pytest.mark.cuda
@pytest.mark.parametrize('b,h,w', [(1, 513, 513), (3, 513, 513), (256, 513, 513),
                                   (1, 33, 33), (1, 17, 49), (2, 257, 449), (2, 7, 7)])
def test_kernel_within_one_bf16_ulp_of_plain_on_card(cuda, b, h, w):
    x, wt, bias = _inputs(b + h + w, b, h, w, cuda)
    before = stem.launches
    got = stem.stem(x, wt, bias)
    torch.cuda.synchronize()
    assert stem.launches == before + 1
    ref = stem.stem_reference(x, wt, bias)
    assert got.shape == ref.shape and got.is_contiguous(memory_format=torch.channels_last)
    assert_within_one_bf16_ulp(got, ref)
    del ref, got
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_one_launch_a_resnet50_bf16_forward_and_none_in_m101(cuda):
    params = resnet50.init_params(torch.Generator().manual_seed(6), _cfg(torch.float32))
    frames = _inputs(7, 2, 129, 129)[0]
    before, convs = stem.launches, resnet50.convs
    with torch.no_grad():
        for dtype in (torch.bfloat16, torch.float32):
            cp = resnet50.cast_params(params, dtype, cuda)
            resnet50.forward(cp, frames.to(cuda), _cfg(dtype))
    torch.cuda.synchronize()
    assert stem.launches - before == 1
    assert resnet50.convs - convs == 2 * 53
    cfg101 = ModelConfig(model_id=101, output_stride=16, compute_dtype=torch.bfloat16)
    p101 = mobilenet_v1.cast_params(
        mobilenet_v1.init_params(torch.Generator().manual_seed(8), cfg101), torch.bfloat16, cuda)
    before = stem.launches
    with torch.no_grad():
        mobilenet_v1.forward(p101, torch.zeros((2, 129, 129, 3), device=cuda), cfg101)
    torch.cuda.synchronize()
    assert stem.launches == before


@pytest.mark.cuda
def test_one_launch_a_resnet50_bf16_pipeline_call(cuda):
    pipe = PoseNetPipeline(ResNet50(16, compute_dtype=torch.bfloat16, device=cuda))
    frames = torch.randint(0, 256, (2, 129, 129, 3), dtype=torch.uint8, device=cuda)
    pipe.warmup((129, 129), batch=2)
    torch.cuda.synchronize()
    before, convs = stem.launches, resnet50.convs
    pipe(frames)
    torch.cuda.synchronize()
    assert (stem.launches - before, resnet50.convs - convs) == (1, 53)
