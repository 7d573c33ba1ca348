"""The PyTorch port's checkpoint reader and layout conversion against the
JAX package's. Weights are copied, never computed, so every comparison
here is exact."""

import numpy as np
import pytest
import torch

import jax

from posenet_tpu.config import ModelConfig as JaxModelConfig
from posenet_tpu.converter import tfjs2jax
from posenet_tpu.models import mobilenet_v1 as jax_mobilenet

from posenet_tpu_torch.config import ModelConfig
from posenet_tpu_torch.converter import weights
from posenet_tpu_torch.models import mobilenet_v1

from tests.make_fixture_checkpoint import FIXTURE_PATH


def numpy_params(model_id, seed=0):
    """A JAX-layout (HWIO) parameter pytree of uniform +-1/sqrt(fan_in)
    numpy weights, shaped from the JAX package's architecture table."""
    rng = np.random.RandomState(seed)

    def conv(shape):
        bound = 1.0 / np.sqrt(np.prod(shape[:3]))
        return (rng.uniform(-bound, bound, shape).astype(np.float32),
                rng.uniform(-bound, bound, shape[-1:]).astype(np.float32))

    layers = []
    for conv_type, inp, outp, _ in jax_mobilenet.ARCHS[model_id]:
        if conv_type == 'input':
            w, b = conv((3, 3, inp, outp))
            layers.append({'w': w, 'b': b})
        else:
            dw_w, dw_b = conv((3, 3, 1, inp))
            pw_w, pw_b = conv((1, 1, inp, outp))
            layers.append({'dw_w': dw_w, 'dw_b': dw_b, 'pw_w': pw_w, 'pw_b': pw_b})
    last = jax_mobilenet.ARCHS[model_id][-1][2]
    heads = {}
    for name, ch in jax_mobilenet.HEAD_CHANNELS.items():
        w, b = conv((1, 1, last, ch))
        heads[name] = {'w': w, 'b': b}
    return {'backbone': layers, 'heads': heads}


def test_load_params_npz_matches_jax_loader():
    ours = weights.load_params_npz(FIXTURE_PATH)
    ref = tfjs2jax.load_params_npz(FIXTURE_PATH)
    assert len(ours['backbone']) == len(ref['backbone']) == 14
    for a, b in zip(ours['backbone'], ref['backbone']):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert ours['heads'].keys() == ref['heads'].keys()
    for name in ref['heads']:
        for k in ('w', 'b'):
            np.testing.assert_array_equal(ours['heads'][name][k],
                                          ref['heads'][name][k])


@pytest.mark.parametrize("model_id", [50, 75, 101])
def test_params_from_jax_layouts_round_trip(model_id):
    """HWIO -> OIHW: the full conv (C,3,3,3), depthwise (C,1,3,3), pointwise
    (C2,C,1,1) and heads (K,C,1,1); permuting back gives the JAX arrays
    bit for bit, and the shapes are the port's own init_params shapes."""
    ref = numpy_params(model_id)
    jax_shapes = jax.eval_shape(lambda: jax_mobilenet.init_params(
        jax.random.PRNGKey(0), JaxModelConfig(model_id=model_id)))
    assert (jax.tree.map(lambda a: a.shape, jax_shapes)
            == jax.tree.map(lambda a: a.shape, ref))
    ours = weights.params_from_jax(ref)
    own = mobilenet_v1.init_params(torch.Generator().manual_seed(0),
                                   ModelConfig(model_id=model_id))
    back = (2, 3, 1, 0)  # OIHW -> HWIO
    for a, b, o in zip(ours['backbone'], ref['backbone'], own['backbone']):
        assert a.keys() == b.keys() == o.keys()
        for k in a:
            assert a[k].dtype == torch.float32 and a[k].is_contiguous()
            assert a[k].shape == o[k].shape
            got = a[k].numpy()
            np.testing.assert_array_equal(got.transpose(back) if got.ndim == 4 else got,
                                          b[k])
    c_last = ref['backbone'][-1]['pw_w'].shape[-1]
    for name, p in ours['heads'].items():
        assert p['w'].shape == (ref['heads'][name]['w'].shape[-1], c_last, 1, 1)
        assert p['w'].shape == own['heads'][name]['w'].shape
        np.testing.assert_array_equal(p['w'].numpy().transpose(back),
                                      ref['heads'][name]['w'])
        np.testing.assert_array_equal(p['b'].numpy(), ref['heads'][name]['b'])
    dw = ours['backbone'][1]['dw_w']
    assert dw.shape == (ref['backbone'][1]['dw_w'].shape[-1], 1, 3, 3)


def test_init_params_kaiming_bounds_and_seeding():
    """Kernels and biases within 1/sqrt(fan_in), as nn.Conv2d's default;
    the same seed gives the same weights, another seed others."""
    cfg = ModelConfig(model_id=50, output_stride=16)
    a = mobilenet_v1.init_params(torch.Generator().manual_seed(1), cfg)
    b = mobilenet_v1.init_params(torch.Generator().manual_seed(1), cfg)
    c = mobilenet_v1.init_params(torch.Generator().manual_seed(2), cfg)
    for la, lb, lc in zip(a['backbone'], b['backbone'], c['backbone']):
        for k, v in la.items():
            assert torch.equal(v, lb[k])
            assert not torch.equal(v, lc[k])
        if 'w' in la:
            fans = {'w': 27, 'b': 27}
        else:
            c_in = la['pw_w'].shape[1]
            fans = {'dw_w': 9, 'dw_b': 9, 'pw_w': c_in, 'pw_b': c_in}
        for k, fan_in in fans.items():
            assert la[k].abs().max() <= 1.0 / np.sqrt(fan_in)
