"""The fused separable block (K2) of the PyTorch port: its plain version
against the JAX package's TPU kernel and conv pair, the trunk's routing to
it, and the wrapper's checks.

Tolerances. The plain version sums the 9 depthwise taps in float32 in the
TPU kernel's (dy, dx) order, and a bf16 x bf16 product is exact in
float32, so the bf16 intermediate is the TPU kernel's; the pointwise
float32 sums differ in order only. An output may therefore land on the
other side of a bf16 rounding boundary: each element is held within one
bf16 ulp of the reference, or within 2^-16 absolute where the float32
accumulation (at most 1024 unit-scale products) cancels to a value so
small that its rounding error spans several bf16 ulps. Measured against
`sepconv_pallas` in interpret mode at B=2, 33x33: 128->128, 4 of 278784
elements differ, by one ulp (share bitwise equal 0.999986); 128->256, 4 of
557568 differ, one by 1.2e-7 absolute (4 ulp of 7.4e-6), the others by one
ulp (0.999993 equal). Against the f32-accumulated XLA conv pair at C_in 16,
24 and 32: bitwise equal; at rates 2 and 4 (`rhs_dilation`), within the
same tolerance. At stride 2 the biases are rounded to bf16 before they
are added, as the conv pair `_conv_relu6` (`F.conv2d` with its bias cast
to bf16) does on the CPU: against that pair within the same tolerance at
every stride-2 layer's widths (bitwise equal at C_in 32-96 and mostly
above, where the CPU's pointwise sums in another order).

The tests marked `cuda` hold the CUDA kernel to its plain version on a
card, with the same tolerance; they skip without one.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax.numpy as jnp
from jax import lax

from posenet_tpu.ops.pallas.sepconv import sepconv_pallas

from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.models import mobilenet_v1
from posenet_tpu_torch.ops import sepconv

from tests.test_torch_decode import cuda  # noqa: F401  (fixture)

ABS_FLOOR = 2.0 ** -16


def assert_bf16_close(got, ref):
    """Each element within one bf16 ulp of `ref`, or within ABS_FLOOR."""
    got = np.asarray(got, np.float32)
    ref = np.asarray(ref, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    excess = np.abs(got - ref) - np.maximum(ulp, ABS_FLOOR)
    assert excess.max() <= 0, f'{int((excess > 0).sum())} elements beyond one bf16 ulp'


def _inputs(seed, b, h, w, c_in, c_out):
    """Activations in ReLU6's range, unit-gain weights, as numpy (JAX
    layouts: HWIO kernels)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(0, 6, (b, h, w, c_in)).astype(np.float32)
    dw = (rng.randn(3, 3, 1, c_in) * 0.4).astype(np.float32)
    dw_b = (rng.randn(c_in) * 0.3).astype(np.float32)
    pw = (rng.randn(1, 1, c_in, c_out) / np.sqrt(c_in)).astype(np.float32)
    pw_b = (rng.randn(c_out) * 0.3).astype(np.float32)
    return x, dw, dw_b, pw, pw_b


def _torch_args(x, dw, dw_b, pw, pw_b, device='cpu'):
    """The wrapper's arguments: bf16 NHWC x, packed taps, OI pointwise."""
    taps = sepconv.pack_depthwise(torch.from_numpy(dw.transpose(3, 2, 0, 1).copy()))
    pw_oi = torch.from_numpy(pw[0, 0].T.copy()).to(torch.bfloat16)
    args = (torch.from_numpy(x).to(torch.bfloat16), taps, torch.from_numpy(dw_b),
            pw_oi, torch.from_numpy(pw_b))
    return tuple(a.to(device) for a in args)


@pytest.mark.parametrize("c_in,c_out", [(128, 128), (128, 256)])
def test_reference_matches_pallas_interpret(c_in, c_out):
    """Against the TPU kernel itself; W padded to a multiple of 8 for its
    Mosaic DMA rule (tests/test_decode.py:284), valid columns compared."""
    x, dw, dw_b, pw, pw_b = _inputs(0, 2, 33, 33, c_in, c_out)
    xp = jnp.concatenate([jnp.asarray(x).astype(jnp.bfloat16),
                          jnp.zeros((2, 33, 7, c_in), jnp.bfloat16)], axis=2)
    ref = sepconv_pallas(xp, jnp.asarray(dw), jnp.asarray(dw_b), jnp.asarray(pw),
                         jnp.asarray(pw_b), valid_w=33, out_w=40, interpret=True)
    ref = np.asarray(ref, np.float32)[:, :, :33]
    ours = sepconv.sepconv(*_torch_args(x, dw, dw_b, pw, pw_b))
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == ref.shape
    assert_bf16_close(ours.float().numpy(), ref)
    assert (ours.float().numpy() == ref).mean() > 0.9999


def _xla_pair(x, dw, dw_b, pw, pw_b, rate=1):
    """The f32-accumulated XLA conv pair at dilation `rate`, padding `rate`:
    bf16 depthwise + f32 bias, clamp, bf16; bf16 pointwise + f32 bias,
    clamp, bf16."""
    dn = ('NHWC', 'HWIO', 'NHWC')
    y = lax.conv_general_dilated(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dw).astype(jnp.bfloat16),
        (1, 1), [(rate, rate), (rate, rate)], rhs_dilation=(rate, rate),
        dimension_numbers=dn, feature_group_count=x.shape[-1],
        preferred_element_type=jnp.float32)
    y = jnp.clip(y + dw_b, 0, 6).astype(jnp.bfloat16)
    y = lax.conv_general_dilated(
        y, jnp.asarray(pw).astype(jnp.bfloat16), (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=dn, preferred_element_type=jnp.float32)
    return np.asarray(jnp.clip(y + pw_b, 0, 6).astype(jnp.bfloat16), np.float32)


@pytest.mark.parametrize("c_in,c_out", [(16, 32), (24, 48), (32, 64)])
def test_reference_matches_xla_pair(c_in, c_out):
    """The C_in the TPU kernel refuses (C_in % 128), against the
    f32-accumulated XLA conv pair, on an odd 17x23 grid."""
    x, dw, dw_b, pw, pw_b = _inputs(1, 2, 17, 23, c_in, c_out)
    ours = sepconv.sepconv(*_torch_args(x, dw, dw_b, pw, pw_b))
    assert_bf16_close(ours.float().numpy(), _xla_pair(x, dw, dw_b, pw, pw_b))


@pytest.mark.parametrize("h,w,rate,c_in,c_out", [
    (5, 5, 4, 64, 128),      # a map smaller than the taps' reach: every
                             # off-centre tap of most pixels is padding
    (33, 33, 2, 128, 128),   # m101 s16's layer 13 grid
    (11, 19, 2, 96, 192),    # non-square
    (11, 19, 4, 256, 256),
])
def test_dilated_reference_matches_xla_pair(h, w, rate, c_in, c_out):
    """The plain version at rates 2 and 4, as the trunk's dilated layers
    run it, against the f32-accumulated XLA conv pair with
    `rhs_dilation=(rate, rate)` and padding `rate`."""
    x, dw, dw_b, pw, pw_b = _inputs(6, 2, h, w, c_in, c_out)
    ours = sepconv.sepconv(*_torch_args(x, dw, dw_b, pw, pw_b), rate=rate)
    assert tuple(ours.shape) == (2, h, w, c_out)
    ref = _xla_pair(x, dw, dw_b, pw, pw_b, rate)
    assert_bf16_close(ours.float().numpy(), ref)
    # the taps really are `rate` apart: rate 1 gives another result
    plain = sepconv.sepconv(*_torch_args(x, dw, dw_b, pw, pw_b))
    assert not torch.equal(plain, ours)


# (C_in, C_out) of every stride-2 separable layer of m50, m75 and m101:
# layers 2, 4 and 6 of each, and m101 s32's layer 12.
STRIDED_LAYERS = [(32, 64), (48, 96), (64, 128), (96, 192), (128, 256), (192, 384),
                  (256, 512), (512, 1024)]


@pytest.mark.parametrize("h,w", [(9, 13), (17, 17)])
@pytest.mark.parametrize("c_in,c_out", STRIDED_LAYERS)
def test_strided_reference_matches_conv_pair(h, w, c_in, c_out):
    """The plain version at stride 2 against the trunk's conv pair, two
    `_conv_relu6` calls in bf16 on the CPU at torch-style padding 1: the
    output map ((H - 1) // 2 + 1, (W - 1) // 2 + 1), each element within
    one bf16 ulp."""
    args = _torch_args(*_inputs(9, 2, h, w, c_in, c_out))
    ours = sepconv.sepconv(*args, stride=2)
    side = ((h - 1) // 2 + 1, (w - 1) // 2 + 1)
    assert ours.dtype == torch.bfloat16 and tuple(ours.shape) == (2, *side, c_out)
    assert ours.is_contiguous()
    x, dw, dw_b, pw, pw_b = args
    pair = mobilenet_v1._conv_relu6(
        mobilenet_v1._conv_relu6(x.permute(0, 3, 1, 2), dw.t().reshape(c_in, 1, 3, 3), dw_b,
                                 stride=2, groups=c_in), pw[:, :, None, None], pw_b)
    pair = pair.permute(0, 2, 3, 1)
    assert pair.dtype == torch.bfloat16 and pair.shape == ours.shape
    assert_bf16_close(ours.float().numpy(), pair.float().numpy())


def test_strided_reference_rounds_the_biases_to_bf16():
    """At stride 2 each float32 sum takes its bias rounded to bf16, then
    one rounding to bf16; at stride 1 the float32 bias. With the centre
    tap 1 and the others 0 the depthwise of x is x's even pixels, so the
    output can be written down; the float32 biases give another one on
    these inputs."""
    x, _, dw_b, pw_oi, pw_b = _torch_args(*_inputs(10, 1, 9, 9, 64, 128))
    taps = torch.zeros((9, 64), dtype=torch.bfloat16)
    taps[4] = 1
    got = sepconv.sepconv(x, taps, dw_b, pw_oi, pw_b, stride=2)
    mid = (x[:, ::2, ::2, :].float() + dw_b.to(torch.bfloat16).float()).clamp(0, 6)
    y = mid.to(torch.bfloat16).float().reshape(-1, 64) @ pw_oi.float().t()
    want = (y + pw_b.to(torch.bfloat16).float()).clamp(0, 6).to(torch.bfloat16)
    assert torch.equal(got, want.reshape(got.shape))
    f32_bias = (y + pw_b).clamp(0, 6).to(torch.bfloat16).reshape(got.shape)
    assert not torch.equal(got, f32_bias)


@pytest.mark.parametrize("a,b", [(0, 2), (2, 5), (5, 6)])
def test_stride2_layer_on_a_slab_is_its_rows_of_the_image(a, b):
    """A stride-2 layer on a halo slab (`row_halo`: the input rows its
    output rows [a, b) read, rows beyond the image as zeros) runs the fused
    block at stride 2 and gives exactly those rows of the whole image's
    output: the first and the last shard and one between, on a map whose
    last output row reads a padding row."""
    cfg = ModelConfig(model_id=50, output_stride=16, compute_dtype=torch.bfloat16)
    layer = mobilenet_v1.stride_plan(50, 16)[2]
    assert layer['stride'] == 2 and layer['inp'] == 32
    p = mobilenet_v1.cast_params(mobilenet_v1.init_params(
        torch.Generator().manual_seed(3), cfg), torch.bfloat16)['backbone'][2]
    x = torch.rand((1, 11, 9, 32)).mul(6).to(torch.bfloat16).permute(0, 3, 1, 2)
    whole = mobilenet_v1.run_layer(layer, p, x, cfg)
    assert tuple(whole.shape) == (1, 64, 6, 5)
    lo, hi = 2 * a - 1, 2 * b
    slab = torch.zeros((1, 32, hi - lo, 9), dtype=torch.bfloat16).contiguous(
        memory_format=torch.channels_last)
    slab[:, :, max(lo, 0) - lo:min(hi, 11) - lo] = x[:, :, max(lo, 0):min(hi, 11)]
    calls = []
    call = sepconv.sepconv
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sepconv, 'sepconv', lambda *args: calls.append(args[6]) or call(*args))
        part = mobilenet_v1.run_layer(layer, p, slab, cfg, row_halo=True)
    assert calls == [2]
    assert torch.equal(part, whole[:, :, a:b])


def test_pack_depthwise_is_tap_major():
    dw = torch.arange(5 * 9, dtype=torch.float32).reshape(5, 1, 3, 3)
    taps = sepconv.pack_depthwise(dw)
    assert taps.shape == (9, 5) and taps.dtype == torch.bfloat16 and taps.is_contiguous()
    for c in range(5):
        for dy in range(3):
            for dx in range(3):
                assert taps[dy * 3 + dx, c] == dw[c, 0, dy, dx]


@pytest.mark.parametrize("model_id", [50, 75, 101])
@pytest.mark.parametrize("stride", [8, 16, 32])
def test_trunk_runs_k2_on_stride1_rate1_layers(monkeypatch, model_id, stride):
    """A bf16 forward calls the fused block once per separable layer, 13
    for each model at every output stride, at the layer's stride and
    dilation rate: at s8 layers 2 and 4 at stride 2, 7-13 dilated (m101's
    13 at rate 4); at s16 layers 2, 4 and 6 at stride 2 (m101: layer 13 at
    rate 2); at s32 layers 2, 4 and 6 at stride 2, and m101's layer 12
    too. On the CPU each call is the plain version, counted here as the
    kernel's `launches` counts on the card."""
    calls = []
    plain = sepconv.sepconv_reference
    monkeypatch.setattr(sepconv, 'sepconv_reference',
                        lambda *a: calls.append((a[0].shape, a[5], a[6])) or plain(*a))
    cfg = ModelConfig(model_id=model_id, output_stride=stride, compute_dtype=torch.bfloat16)
    plan = mobilenet_v1.stride_plan(model_id, stride)
    assert sum(mobilenet_v1.uses_sepconv(l, cfg) for l in plan) == 13
    params = mobilenet_v1.cast_params(
        mobilenet_v1.init_params(torch.Generator().manual_seed(stride), cfg), torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 33, 33, 3))
                         .astype(np.float32))
    heads = mobilenet_v1.forward(params, x, cfg)
    assert len(calls) == 13
    assert all(torch.isfinite(h).all() for h in heads.values())
    rates = [r for _, r, _ in calls]
    strides = [s for _, _, s in calls]
    strided = {8: [2, 4], 16: [2, 4, 6],
               32: [2, 4, 6, 12] if model_id == 101 else [2, 4, 6]}[stride]
    assert strides == [2 if layer in strided else 1 for layer in range(1, 14)]
    if model_id == 101 and stride == 16:   # layers 1-12, 13 at rate 2
        assert [s[-1] for s, _, _ in calls] == [32, 64, 128, 128, 256, 256] + [512] * 6 + [1024]
        assert [s[1] for s, _, _ in calls] == [17, 17, 9, 9, 5, 5] + [3] * 7
        assert rates == [1] * 12 + [2]
    if stride == 8:                        # layers 1-6, then 7-13 dilated
        assert rates == [1] * 6 + [2] * 6 + [4 if model_id == 101 else 2]
    if stride == 32:
        assert rates == [1] * 13


def test_f32_trunk_and_uncast_params_route(monkeypatch):
    """The float32 parity mode never takes the fused block; a bf16 trunk
    on uncast float32 parameters takes it with kernels cast per call, and
    gives the features the cast parameters give."""
    calls = []
    plain = sepconv.sepconv_reference
    monkeypatch.setattr(sepconv, 'sepconv_reference',
                        lambda *a: calls.append(1) or plain(*a))
    gen = torch.Generator().manual_seed(1)
    cfg32 = ModelConfig(model_id=50, output_stride=16)
    params = mobilenet_v1.init_params(gen, cfg32)
    x = torch.from_numpy(np.random.RandomState(1).uniform(-1, 1, (2, 33, 49, 3))
                         .astype(np.float32))
    mobilenet_v1.forward(params, x, cfg32)
    assert calls == []
    cfg16 = ModelConfig(model_id=50, output_stride=16, compute_dtype=torch.bfloat16)
    uncast = mobilenet_v1.run_trunk(params, x, cfg16)
    cast = mobilenet_v1.run_trunk(mobilenet_v1.cast_params(params, torch.bfloat16), x, cfg16)
    assert len(calls) == 26
    assert uncast.dtype == torch.bfloat16
    assert torch.equal(uncast, cast)


@pytest.mark.parametrize("case", ["x_f32", "x_nchw_memory", "c_in_12", "c_out_40",
                                  "c_in_2048", "taps_shape", "bias_bf16", "meta_device",
                                  "rate_0", "rate_float", "stride_0", "stride_3",
                                  "stride_float", "stride_2_rate_2", "stride_2_c_in_1024"])
def test_wrapper_rejects(case):
    x, dw, dw_b, pw, pw_b = _inputs(2, 1, 5, 7, 16, 32)
    args = list(_torch_args(x, dw, dw_b, pw, pw_b))
    if case.startswith("rate"):
        with pytest.raises(ValueError, match="rate"):
            sepconv.sepconv(*args, rate=0 if case == "rate_0" else 2.0)
        return
    if case.startswith("stride"):
        kwargs = {"stride_0": dict(stride=0), "stride_3": dict(stride=3),
                  "stride_float": dict(stride=2.0), "stride_2_rate_2": dict(stride=2, rate=2),
                  "stride_2_c_in_1024": dict(stride=2)}[case]
        if case == "stride_2_c_in_1024":   # C_in 1024 runs at stride 1 only
            args = list(_torch_args(*_inputs(2, 1, 5, 7, 1024, 32)))
            assert sepconv.sepconv(*args).shape == (1, 5, 7, 32)
        with pytest.raises(ValueError, match="stride"):
            sepconv.sepconv(*args, **kwargs)
        return
    if case == "x_f32":
        args[0] = args[0].float()
    elif case == "x_nchw_memory":   # NHWC shape over NCHW memory
        args[0] = args[0].permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif case == "c_in_12":
        args = [args[0][..., :12], args[1][:, :12].contiguous(), args[2][:12],
                args[3][:, :12].contiguous(), args[4]]
    elif case == "c_out_40":
        args[3] = torch.zeros((40, 16), dtype=torch.bfloat16)
        args[4] = torch.zeros((40,))
    elif case == "c_in_2048":
        args = [torch.zeros((1, 2, 2, 2048), dtype=torch.bfloat16),
                torch.zeros((9, 2048), dtype=torch.bfloat16), torch.zeros((2048,)),
                torch.zeros((32, 2048), dtype=torch.bfloat16), args[4]]
    elif case == "taps_shape":
        args[1] = args[1].t().contiguous()
    elif case == "bias_bf16":
        args[2] = args[2].to(torch.bfloat16)
    elif case == "meta_device":
        args = [a.to('meta') for a in args]
    with pytest.raises(ValueError):
        sepconv.sepconv(*args)


def test_wrapper_counts_only_kernel_launches():
    """CPU tensors take the plain version and leave the launch count alone."""
    before = sepconv.launches
    out = sepconv.sepconv(*_torch_args(*_inputs(3, 1, 9, 9, 24, 48)))
    assert out.shape == (1, 9, 9, 48) and out.is_contiguous()
    assert sepconv.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c_in,c_out", [
    # every K2 layer of the four models at 513x513: m101 s16, then the
    # C_in 16 and 24 stems, m101 s32's last (BM = 64), the rest of m50,
    # m75 and m101 s8
    (2, 257, 257, 32, 64), (2, 129, 129, 128, 128), (2, 65, 65, 256, 256),
    (2, 33, 33, 512, 512), (2, 33, 33, 512, 1024), (2, 257, 257, 16, 32),
    (2, 257, 257, 24, 48), (2, 17, 17, 1024, 1024), (2, 129, 129, 64, 64),
    (2, 129, 129, 96, 96), (2, 65, 65, 128, 256), (2, 65, 65, 192, 192),
    (2, 65, 65, 192, 384), (2, 65, 65, 256, 512), (2, 33, 33, 256, 256),
    (2, 33, 33, 384, 384),
    # smaller than one block with a ragged pixel tile; odd widths
    (1, 9, 9, 512, 512), (2, 33, 33, 1024, 1024), (2, 17, 23, 96, 96), (2, 5, 7, 8, 16)])
def test_kernel_matches_plain_on_card(cuda, b, h, w, c_in, c_out):   # noqa: F811
    args = _torch_args(*_inputs(4, b, h, w, c_in, c_out), device=cuda)
    before = sepconv.launches
    got = sepconv.sepconv(*args)
    torch.cuda.synchronize()
    assert sepconv.launches == before + 1
    ref = sepconv.sepconv_reference(*args)
    assert_bf16_close(got.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c_in,c_out,rate", [
    # the cells' dilated layers: m101 s16 b128's layer 13 (at B=2), m101 s8
    # 720p b4's layers 7-11, 12 and 13
    (2, 33, 33, 1024, 1024, 2), (4, 91, 161, 512, 512, 2), (4, 91, 161, 512, 1024, 2),
    (4, 91, 161, 1024, 1024, 4),
    # m50's and m75's s8 layers, a ragged one-block pixel tile, a map smaller
    # than the taps' reach, and the BN = 16 fallback below C_in 256
    (2, 65, 65, 256, 256, 2), (2, 65, 65, 384, 384, 2), (1, 9, 9, 512, 512, 2),
    (1, 5, 5, 1024, 1024, 4), (2, 11, 19, 64, 48, 2)])
def test_dilated_kernel_matches_plain_on_card(cuda, b, h, w, c_in, c_out, rate):   # noqa: F811
    args = _torch_args(*_inputs(7, b, h, w, c_in, c_out), device=cuda)
    before = sepconv.launches
    got = sepconv.sepconv(*args, rate=rate)
    torch.cuda.synchronize()
    assert sepconv.launches == before + 1
    ref = sepconv.sepconv_reference(*args, rate)
    assert_bf16_close(got.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w,c_in,c_out", [
    # layers 2, 4 and 6 of m101 at 513x513 (input maps), B=2 and 3, so the
    # last pixel tile is ragged
    (2, 257, 257, 64, 128), (3, 129, 129, 128, 256), (3, 65, 65, 256, 512),
    # m101 s32's layer 12; m50's and m75's layers 2, 4 and 6; the s8 720p
    # cell's layers 2 and 4 (input maps)
    (2, 33, 33, 512, 1024), (2, 257, 257, 32, 64), (2, 129, 129, 64, 128),
    (2, 65, 65, 128, 256), (2, 257, 257, 48, 96), (2, 129, 129, 96, 192),
    (2, 65, 65, 192, 384), (2, 361, 641, 64, 128), (2, 181, 321, 128, 256),
    # one block with a ragged tile, even sides, the BN = 16 fallbacks
    (1, 9, 9, 512, 1024), (1, 16, 22, 64, 128), (2, 17, 13, 64, 48), (1, 10, 12, 128, 80),
    (1, 11, 9, 256, 112)])
def test_strided_kernel_matches_plain_on_card(cuda, b, h, w, c_in, c_out):   # noqa: F811
    args = _torch_args(*_inputs(11, b, h, w, c_in, c_out), device=cuda)
    before, strided = sepconv.launches, sepconv.strided_launches
    got = sepconv.sepconv(*args, stride=2)
    torch.cuda.synchronize()
    assert (sepconv.launches, sepconv.strided_launches) == (before + 1, strided + 1)
    assert tuple(got.shape) == (b, (h - 1) // 2 + 1, (w - 1) // 2 + 1, c_out)
    ref = sepconv.sepconv_reference(*args, 1, 2)
    assert_bf16_close(got.float().cpu().numpy(), ref.float().cpu().numpy())


@pytest.mark.cuda
def test_op_without_rate_runs_at_rate_1(cuda):   # noqa: F811
    """The op as programs exported before it took a rate and a stride call
    it: five tensors, no rate, no stride. It runs at rate 1 and stride 1,
    bitwise the wrapper's result."""
    args = _torch_args(*_inputs(8, 2, 17, 23, 256, 256), device=cuda)
    old = torch.ops.posenet_tpu_torch.sepconv.default(*args)
    new = sepconv.sepconv(*args, rate=1, stride=1)
    torch.cuda.synchronize()
    assert torch.equal(old, new)
    assert not torch.equal(old, sepconv.sepconv(*args, rate=2))
    assert sepconv.sepconv(*args, stride=2).shape == (2, 9, 12, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("stride,launches,strided", [(16, 13, 3), (8, 13, 2)])
def test_bf16_trunk_on_card_runs_k2(cuda, stride, launches, strided):   # noqa: F811
    """An m101 bf16 forward launches K2 13 times at s16 (layers 2, 4 and 6
    at stride 2, layer 13 at rate 2) and 13 times at s8 (layers 2 and 4 at
    stride 2, 7-13 dilated), and its heads stay within the bf16 trunk's
    2e-3 of the CPU's (tests/test_torch_mobilenet.py)."""
    cfg = ModelConfig(model_id=101, output_stride=stride, compute_dtype=torch.bfloat16)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(5), cfg)
    x = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (2, 65, 65, 3))
                         .astype(np.float32))
    ref = mobilenet_v1.forward(mobilenet_v1.cast_params(params, torch.bfloat16), x, cfg)
    before = sepconv.launches, sepconv.strided_launches
    got = mobilenet_v1.forward(mobilenet_v1.cast_params(params, torch.bfloat16, cuda),
                               x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert (sepconv.launches, sepconv.strided_launches) == (before[0] + launches,
                                                            before[1] + strided)
    for k in ref:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), atol=2e-3, rtol=0)
