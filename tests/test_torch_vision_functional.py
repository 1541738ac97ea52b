"""The port's activations and losses against the JAX package's, on the
CPU, at small sizes: each activation, each loss (weighted, ignored
labels, soft labels, every reduction used) and CTC, the output within
1e-5 and the input gradients under one random cotangent within 1e-4 of
each gradient's largest entry; the activation and loss layers."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu import nn as jnn
from paddle_tpu.core.tensor import Tensor as JT

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch.nn import functional as TF

FWD_TOL = 1e-5
GRAD_TOL = 1e-4


def _rand(rs, *shape):
    return rs.randn(*shape).astype(np.float32)


def _port_vjp(fn, arrays, g):
    ts = [torch.tensor(a, requires_grad=True) for a in arrays]
    out = fn(*ts)
    out.backward(torch.from_numpy(np.asarray(g)))
    return out.detach().numpy(), [t.grad.numpy() for t in ts]


def _assert_vjp(ref_fn, port_fn, arrays, seed=0):
    """The reference's output and its input gradients under one random
    cotangent (``jax.vjp``, under one ``jax.jit``: eagerly each new
    shape costs a second) against the port's."""
    arrays = [np.asarray(a) for a in arrays]

    def fwd(*vals):
        return ref_fn(*[JT(v) for v in vals])._value
    shape = jax.eval_shape(fwd, *arrays)
    g = np.asarray(np.random.RandomState(seed + 100).randn(*shape.shape),
                   np.float32)

    @jax.jit
    def out_and_grads(*vals):
        out, vjp = jax.vjp(fwd, *vals)
        return out, vjp(jnp.asarray(g, out.dtype))
    rout, rgrads = out_and_grads(*arrays)
    rout = np.asarray(rout)
    pout, pgrads = _port_vjp(port_fn, arrays, g)
    assert pout.shape == rout.shape
    np.testing.assert_allclose(pout, rout, rtol=FWD_TOL, atol=FWD_TOL)
    for i, (pg, rg) in enumerate(zip(pgrads, rgrads)):
        rg = np.asarray(rg)
        err = np.abs(pg - rg).max()
        assert err <= GRAD_TOL * max(np.abs(rg).max(), 1.0), (i, err)


ACTS = ['relu', 'relu6', 'leaky_relu', 'elu', 'selu', 'gelu', 'sigmoid',
        'hardsigmoid', 'hardswish', 'hardshrink', 'hardtanh', 'softshrink',
        'tanhshrink', 'softplus', 'softsign', 'swish', 'mish', 'log_sigmoid',
        'log_softmax', 'softmax', 'tanh', 'thresholded_relu', 'glu', 'celu',
        'soft_relu']

@pytest.mark.parametrize('name', ACTS)
def test_activations_match_reference(name):
    x = _rand(np.random.RandomState(8), 3, 8) * 4
    _assert_vjp(lambda v: getattr(JF, name)(v),
                lambda v: getattr(TF, name)(v), [x])

def test_activation_layers_and_prelu_maxout():
    x = _rand(np.random.RandomState(9), 2, 4, 3)
    for cls, args in (('ReLU6', ()), ('LeakyReLU', (0.2,)), ('Hardswish', ()),
                      ('Softmax', (1,)), ('GELU', (True,)), ('Maxout', (2,))):
        want = getattr(jnn, cls)(*args)(JT(jnp.asarray(x)))
        got = getattr(tnn, cls)(*args)(torch.tensor(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                                   rtol=FWD_TOL, atol=FWD_TOL)
    w = np.array([0.1, 0.2, 0.3, 0.4], np.float32)
    _assert_vjp(JF.prelu, TF.prelu, [x, w])

def _loss_cases(rs):
    logits = _rand(rs, 6, 5)
    labels = rs.randint(0, 5, 6).astype(np.int64)
    labels[2] = -100
    probs = 1 / (1 + np.exp(-_rand(rs, 6, 5)))
    target = (rs.rand(6, 5) > 0.5).astype(np.float32)
    a, b = _rand(rs, 6, 5), _rand(rs, 6, 5)
    sign = np.where(rs.rand(6) > 0.5, 1.0, -1.0).astype(np.float32)
    cw = np.abs(_rand(rs, 5)) + 0.1
    soft = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    return [
        ('cross_entropy', [logits], [labels], {}),
        ('cross_entropy', [logits], [labels], {'weight': cw}),
        ('cross_entropy', [logits], [labels], {'reduction': 'none'}),
        ('cross_entropy', [logits], [soft], {'soft_label': True}),
        ('cross_entropy', [soft], [np.clip(labels, 0, 4)],
         {'use_softmax': False, 'reduction': 'sum'}),
        ('softmax_with_cross_entropy', [logits], [labels[:, None]], {}),
        ('binary_cross_entropy', [probs], [target], {}),
        ('binary_cross_entropy', [probs], [target], {'weight': cw,
                                                     'reduction': 'sum'}),
        ('binary_cross_entropy_with_logits', [a], [target],
         {'pos_weight': cw}),
        ('l1_loss', [a], [b], {}),
        ('mse_loss', [a], [b], {'reduction': 'sum'}),
        ('smooth_l1_loss', [a], [b], {'delta': 0.5}),
        ('huber_loss', [a], [b], {'delta': 0.7}),
        ('nll_loss', [np.log(soft)], [labels], {'weight': cw}),
        ('nll_loss', [np.log(soft)], [labels], {}),
        ('kl_div', [np.log(soft)], [probs / probs.sum(-1, keepdims=True)],
         {'reduction': 'batchmean'}),
        ('margin_ranking_loss', [a[:, 0], b[:, 0]], [sign], {'margin': 0.1}),
        ('log_loss', [probs], [target], {}),
        ('sigmoid_focal_loss', [a], [target], {}),
        ('hinge_embedding_loss', [a[:, 0]], [sign], {}),
        ('cosine_embedding_loss', [a, b], [sign], {'margin': 0.2}),
        ('triplet_margin_loss', [a, b, a[::-1].copy()], [], {'swap': True}),
        ('square_error_cost', [a], [b], {}),
        ('npair_loss', [a, b], [labels.astype(np.float32)], {}),
    ]

@pytest.mark.parametrize('case', range(24))
def test_losses_match_reference(case):
    name, diff, fixed, kw = _loss_cases(np.random.RandomState(11))[case]

    def call(F, consts):
        conv = (lambda a: JT(jnp.asarray(a))) if F is JF else \
            torch.from_numpy
        kws = {k: conv(v) if isinstance(v, np.ndarray) else v
               for k, v in kw.items()}
        return lambda *v: getattr(F, name)(*v, *consts, **kws)
    ref = call(JF, [JT(jnp.asarray(f)) for f in fixed])
    port = call(TF, [torch.from_numpy(f) for f in fixed])
    _assert_vjp(ref, port, diff, case)

def test_ctc_loss_matches_reference():
    rs = np.random.RandomState(12)
    T, N, C, S = 7, 2, 5, 3
    logits = _rand(rs, T, N, C)
    labels = rs.randint(1, C, (N, S)).astype(np.int32)
    labels[0, 1] = labels[0, 0]                 # a repeat
    il = np.array([7, 5], np.int32)
    ll = np.array([3, 2], np.int32)
    for red in ('mean', 'none'):
        def ref(v):
            return JF.ctc_loss(v, JT(jnp.asarray(labels)),
                               JT(jnp.asarray(il)), JT(jnp.asarray(ll)),
                               reduction=red)

        def port(v):
            return TF.ctc_loss(v, torch.from_numpy(labels),
                               torch.from_numpy(il), torch.from_numpy(ll),
                               reduction=red)
        _assert_vjp(ref, port, [logits])
    layer = tnn.CTCLoss()(torch.from_numpy(logits), torch.from_numpy(labels),
                          torch.from_numpy(il), torch.from_numpy(ll))
    assert torch.isfinite(layer)

def test_loss_layers_match_functionals():
    rs = np.random.RandomState(13)
    logits = torch.from_numpy(_rand(rs, 4, 3))
    labels = torch.tensor([0, 2, 1, 2])
    assert torch.equal(tnn.CrossEntropyLoss()(logits, labels),
                       TF.cross_entropy(logits, labels))
    assert torch.equal(tnn.MSELoss('sum')(logits, logits * 2),
                       TF.mse_loss(logits, logits * 2, 'sum'))
    assert torch.equal(tnn.TripletMarginLoss(margin=0.5)(
        logits, logits * 2, -logits), TF.triplet_margin_loss(
        logits, logits * 2, -logits, margin=0.5))
    want = jnn.PairwiseDistance()(JT(jnp.asarray(logits.numpy())),
                                  JT(jnp.asarray(logits.numpy() * 3)))
    got = tnn.PairwiseDistance()(logits, logits * 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want._value),
                               rtol=FWD_TOL)
