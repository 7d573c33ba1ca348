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
24 and 32: bitwise equal.

The tests marked `cuda` hold the CUDA kernel to its plain version on a
card, with the same tolerance; they skip without one.
"""

import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("c_in,c_out", [(16, 32), (24, 48), (32, 64)])
def test_reference_matches_xla_pair(c_in, c_out):
    """The C_in the TPU kernel refuses (C_in % 128), against the
    f32-accumulated XLA conv pair, on an odd 17x23 grid."""
    x, dw, dw_b, pw, pw_b = _inputs(1, 2, 17, 23, c_in, c_out)
    dn = ('NHWC', 'HWIO', 'NHWC')
    y = lax.conv_general_dilated(
        jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(dw).astype(jnp.bfloat16),
        (1, 1), [(1, 1), (1, 1)], dimension_numbers=dn, feature_group_count=c_in,
        preferred_element_type=jnp.float32)
    y = jnp.clip(y + dw_b, 0, 6).astype(jnp.bfloat16)
    y = lax.conv_general_dilated(
        y, jnp.asarray(pw).astype(jnp.bfloat16), (1, 1), [(0, 0), (0, 0)],
        dimension_numbers=dn, preferred_element_type=jnp.float32)
    ref = np.asarray(jnp.clip(y + pw_b, 0, 6).astype(jnp.bfloat16), np.float32)
    ours = sepconv.sepconv(*_torch_args(x, dw, dw_b, pw, pw_b))
    assert_bf16_close(ours.float().numpy(), ref)


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
    """A bf16 forward calls the fused block once per separable layer the
    stride plan leaves at stride 1 and rate 1: 4 at s8; 10 for m50 and m75
    and 9 for m101 at s16 and s32. On the CPU each call is the plain
    version, counted here as the kernel's `launches` counts on the card."""
    calls = []
    plain = sepconv.sepconv_reference
    monkeypatch.setattr(sepconv, 'sepconv_reference',
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    expected = {8: 4, 16: 9 if model_id == 101 else 10, 32: 9 if model_id == 101 else 10}
    cfg = ModelConfig(model_id=model_id, output_stride=stride, compute_dtype=torch.bfloat16)
    plan = mobilenet_v1.stride_plan(model_id, stride)
    assert sum(mobilenet_v1.uses_sepconv(l, cfg) for l in plan) == expected[stride]
    params = mobilenet_v1.cast_params(
        mobilenet_v1.init_params(torch.Generator().manual_seed(stride), cfg), torch.bfloat16)
    x = torch.from_numpy(np.random.RandomState(0).uniform(-1, 1, (1, 33, 33, 3))
                         .astype(np.float32))
    heads = mobilenet_v1.forward(params, x, cfg)
    assert len(calls) == expected[stride]
    assert all(torch.isfinite(h).all() for h in heads.values())
    if model_id == 101 and stride == 16:   # layers 1, 3, 5, 7-12
        assert [s[-1] for s in calls] == [32, 128, 256] + [512] * 6


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
    assert len(calls) == 20
    assert uncast.dtype == torch.bfloat16
    assert torch.equal(uncast, cast)


@pytest.mark.parametrize("case", ["x_f32", "x_nchw_memory", "c_in_12", "c_out_40",
                                  "c_in_2048", "taps_shape", "bias_bf16", "meta_device"])
def test_wrapper_rejects(case):
    x, dw, dw_b, pw, pw_b = _inputs(2, 1, 5, 7, 16, 32)
    args = list(_torch_args(x, dw, dw_b, pw, pw_b))
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
def test_bf16_trunk_on_card_runs_k2(cuda):   # noqa: F811
    """An m101 s16 bf16 forward launches K2 9 times, and its heads stay
    within the bf16 trunk's 2e-3 of the CPU's (tests/test_torch_mobilenet.py)."""
    cfg = ModelConfig(model_id=101, output_stride=16, compute_dtype=torch.bfloat16)
    params = mobilenet_v1.init_params(torch.Generator().manual_seed(5), cfg)
    x = torch.from_numpy(np.random.RandomState(5).uniform(-1, 1, (2, 65, 65, 3))
                         .astype(np.float32))
    ref = mobilenet_v1.forward(mobilenet_v1.cast_params(params, torch.bfloat16), x, cfg)
    before = sepconv.launches
    got = mobilenet_v1.forward(mobilenet_v1.cast_params(params, torch.bfloat16, cuda),
                               x.to(cuda), cfg)
    torch.cuda.synchronize()
    assert sepconv.launches == before + 9
    for k in ref:
        np.testing.assert_allclose(got[k].cpu().numpy(), ref[k].numpy(), atol=2e-3, rtol=0)
