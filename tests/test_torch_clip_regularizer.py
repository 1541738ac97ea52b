"""The port's gradient clips (``nn.clip``), regularizers
(``nn.regularizer``) and ``nn.initializer.ParamAttr`` against the JAX
package's: the same numpy gradients and parameters through both, each
clipped or regularized gradient within 1e-6 of its tensor's largest value
(the norms sum in another order), ``need_clip`` honoured, the global norm
and the scale left on the device as 0-dim tensors, and the ParamAttr
settings on the parameters the layers make."""
import copy

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.nn import clip as jax_clip
from paddle_tpu.nn import regularizer as jax_reg

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import regularizer as fluid_reg
from paddle_tpu_torch.nn import clip as torch_clip
from paddle_tpu_torch.nn import regularizer as torch_reg
from paddle_tpu_torch.nn.initializer import ParamAttr, copy_param_attrs

TOL = 1e-6


class _Meta:
    def __init__(self, need_clip):
        self.need_clip = need_clip


def _grads(seed=0, scale=1.0):
    rs = np.random.RandomState(seed)
    shapes = [(7, 5), (5,), (3, 4, 2), (1,)]
    return [(rs.randn(*s) * scale).astype(np.float32) for s in shapes]


def _run(make, grads, need):
    metas = [_Meta(n) for n in need]
    got = make(torch_clip)([(m, torch.tensor(g)) for m, g in
                            zip(metas, grads)])
    want = make(jax_clip)([(m, jnp.asarray(g)) for m, g in
                           zip(metas, grads)])
    for (mg, g), (mw, w) in zip(got, want):
        assert mg is mw or mg.need_clip == mw.need_clip
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= TOL * max(np.abs(w).max(),
                                                          1e-30)
    return [g for _, g in got]


CLIPS = {'value': lambda m: m.ClipGradByValue(0.5, -0.3),
         'value_symmetric': lambda m: m.ClipGradByValue(0.4),
         'norm': lambda m: m.ClipGradByNorm(1.5),
         'global_norm': lambda m: m.ClipGradByGlobalNorm(2.0)}


@pytest.mark.parametrize("scale", [0.05, 3.0], ids=['inside', 'clipped'])
@pytest.mark.parametrize("need", [(True,) * 4, (True, False, True, False)],
                         ids=['all', 'need_clip'])
@pytest.mark.parametrize("kind", sorted(CLIPS))
def test_clip_matches_reference(kind, need, scale):
    grads = _grads(scale=scale)
    out = _run(CLIPS[kind], grads, need)
    for g, n, o in zip(grads, need, out):
        if not n:
            assert np.array_equal(o.numpy(), g)


def test_global_norm_stays_on_the_device_as_0_dim_tensors():
    grads = [torch.tensor(g) for g in _grads(scale=3.0)]
    clip = torch_clip.ClipGradByGlobalNorm(1.0)
    norm = torch_clip.global_norm(grads)
    scale = clip.scale(grads)
    assert norm.dim() == 0 and scale.dim() == 0
    want = np.sqrt(sum(float((g.double() ** 2).sum()) for g in grads))
    assert float(norm) == pytest.approx(want, rel=1e-6)
    assert float(scale) == pytest.approx(1.0 / want, rel=1e-6)
    # an inf gradient gives an inf norm and a 0 scale: the scaler's ok
    # select then discards the step
    bad = grads + [torch.tensor([float('inf')])]
    assert float(clip.scale(bad)) == 0.0


def test_clip_grad_norm_scales_the_grads_in_place():
    ps = [torch.nn.Parameter(torch.zeros(s)) for s in ((7, 5), (5,))]
    gs = [torch.tensor(g) for g in _grads(2, 5.0)[:2]]
    for p, g in zip(ps, gs):
        p.grad = g.clone()
    total = torch_clip.clip_grad_norm_(ps, 1.0)
    want = np.sqrt(sum(float((g.double() ** 2).sum()) for g in gs))
    assert float(total) == pytest.approx(want, rel=1e-6)
    now = np.sqrt(sum(float((p.grad.double() ** 2).sum()) for p in ps))
    assert now == pytest.approx(1.0, rel=1e-5)
    peak = float(ps[0].grad.abs().max())
    inf_total = tnn.clip_grad_norm_(ps[0], 0.1, norm_type=float('inf'))
    assert float(inf_total) == peak
    assert float(ps[0].grad.abs().max()) == pytest.approx(0.1, rel=1e-6)
    assert float(torch_clip.clip_grad_norm_(
        [torch.nn.Parameter(torch.zeros(2))], 1.0)) == 0.0


@pytest.mark.parametrize("kind", ['L1Decay', 'L2Decay'])
def test_regularizer_matches_reference(kind):
    rs = np.random.RandomState(1)
    p = rs.randn(6, 3).astype(np.float32)
    g = rs.randn(6, 3).astype(np.float32)
    mine = getattr(torch_reg, kind)(0.03)
    ref = getattr(jax_reg, kind)(0.03)
    assert mine.coeff == ref.coeff
    np.testing.assert_allclose(mine.grad_term(torch.tensor(p)).numpy(),
                               np.asarray(ref.grad_term(jnp.asarray(p))),
                               rtol=1e-7, atol=0)
    (summed,) = mine.add_grad_terms([torch.tensor(g)], [torch.tensor(p)])
    np.testing.assert_allclose(
        summed.numpy(), g + np.asarray(ref.grad_term(jnp.asarray(p))),
        rtol=1e-6, atol=1e-7)
    loss = mine.loss(torch.tensor(p))
    want = 0.03 * (np.abs(p).sum() if kind == 'L1Decay'
                   else 0.5 * (p * p).sum())
    assert float(loss) == pytest.approx(float(want), rel=1e-5)
    assert repr(mine) == repr(ref)


def test_fluid_aliases():
    assert torch_clip.GradientClipByValue is torch_clip.ClipGradByValue
    assert torch_clip.GradientClipByNorm is torch_clip.ClipGradByNorm
    assert torch_clip.GradientClipByGlobalNorm is \
        torch_clip.ClipGradByGlobalNorm
    assert torch_reg.L1DecayRegularizer is torch_reg.L1Decay
    assert fluid_reg.L2DecayRegularizer is torch_reg.L2Decay


def test_param_attr_lands_on_the_parameters():
    reg = torch_reg.L1Decay(0.2)
    lin = tnn.Linear(4, 3, ParamAttr(learning_rate=0.5, regularizer=reg,
                                     need_clip=False),
                     ParamAttr(trainable=False), device='cpu')
    assert lin.weight.optimize_attr == {'learning_rate': 0.5}
    assert lin.weight.regularizer is reg and lin.weight.need_clip is False
    assert lin.weight.requires_grad and not lin.bias.requires_grad
    assert tnn.Linear(4, 3, bias_attr=False, device='cpu').bias is None
    emb = tnn.Embedding(10, 4, weight_attr=ParamAttr(learning_rate=2.0),
                        device='cpu')
    assert emb.weight.optimize_attr['learning_rate'] == 2.0
    ln = tnn.LayerNorm(4, weight_attr=False, bias_attr='ln_b', device='cpu')
    assert ln.weight is None and ln.bias.need_clip is True
    x = torch.randn(2, 4)
    np.testing.assert_allclose(
        ln(x).detach().numpy(),
        ((x - x.mean(-1, keepdim=True)) /
         torch.sqrt(x.var(-1, unbiased=False, keepdim=True) + 1e-5)).numpy(),
        rtol=1e-5, atol=1e-5)
    # a deepcopy drops them (torch's Parameter.__deepcopy__);
    # copy_param_attrs carries them over, as TransformerEncoder's clones do
    twin = copy.deepcopy(lin)
    assert not hasattr(twin.weight, 'need_clip')
    copy_param_attrs(lin, twin)
    assert twin.weight.need_clip is False and not twin.bias.requires_grad
    layer = tnn.TransformerEncoderLayer(
        8, 2, 16, dropout=0.0, weight_attr=ParamAttr(learning_rate=0.1),
        device='cpu')
    enc = tnn.TransformerEncoder(layer, 2)
    assert enc.layers[1].linear2.weight.optimize_attr == \
        {'learning_rate': 0.1}
    # as in the reference, a ParamAttr keeps whatever initializer it is
    # given, and the layer that calls it raises (tests/
    # test_torch_initializers.py runs the real ones)
    from paddle_tpu import nn as jax_nn
    from paddle_tpu.nn.initializer import ParamAttr as JaxParamAttr
    attr = ParamAttr(initializer=object())
    assert attr.initializer is not None
    with pytest.raises(TypeError):
        jax_nn.Linear(4, 3, JaxParamAttr(initializer=object()))
    with pytest.raises(TypeError):
        tnn.Linear(4, 3, attr, device='cpu')
    with pytest.raises(TypeError):
        ParamAttr._to_attr(3.0)
