"""Shared helpers of the detection tests (``test_torch_vision_ops.py``,
``test_torch_detection_*.py``, ``test_torch_ssd.py``): the reference's
ops run under one ``jax.jit`` a call (eagerly, op by op, they cost seconds
each on this CPU), seeded box makers, and the tolerance check."""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from paddle_tpu.core.tensor import Tensor as JT


def _values(out):
    if isinstance(out, JT):
        return out._value
    if isinstance(out, (list, tuple)):
        return type(out)(_values(o) for o in out)
    return out


def _numpy(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_numpy(o) for o in out)
    return np.asarray(out)


def ref(fn, *arrays, **kw):
    """``fn(*JT(arrays), **kw)`` under ``jax.jit`` -> numpy (the same
    nesting of tuples and lists as ``fn``'s result)."""
    def run(*vals):
        return _values(fn(*[JT(v) for v in vals], **kw))
    return _numpy(jax.jit(run)(*[jnp.asarray(a) for a in arrays]))


def ref_vjp(fn, arrays, cot, argnums, **kw):
    """The reference's output and the gradients of ``sum(out * cot)``
    with respect to ``arrays[i]`` for ``i`` in ``argnums``, under one
    ``jax.jit`` -> (out, [grads])."""
    def f(*vals):
        return _values(fn(*[JT(v) for v in vals], **kw))

    @jax.jit
    def run(*vals):
        def scalar(*diff):
            full = list(vals)
            for i, d in zip(argnums, diff):
                full[i] = d
            out = f(*full)
            return jnp.sum(out * cot), out
        (_, out), grads = jax.value_and_grad(
            scalar, argnums=tuple(range(len(argnums))), has_aux=True)(
            *[vals[i] for i in argnums])
        return out, grads
    out, grads = run(*[jnp.asarray(a) for a in arrays])
    return np.asarray(out), [np.asarray(g) for g in grads]


def port(fn, *arrays, **kw):
    """``fn`` on CPU tensors of ``arrays`` -> numpy (nested like its
    result)."""
    out = fn(*[torch.from_numpy(np.asarray(a)) for a in arrays], **kw)
    return _numpy_t(out)


def _numpy_t(out):
    if isinstance(out, (list, tuple)):
        return type(out)(_numpy_t(o) for o in out)
    if isinstance(out, torch.Tensor):
        return out.detach().numpy()
    return np.asarray(out)


def port_vjp(fn, arrays, cot, argnums, **kw):
    """The port's output and the gradients of ``sum(out * cot)``."""
    ts = [torch.tensor(np.asarray(a), requires_grad=i in argnums)
          for i, a in enumerate(arrays)]
    out = fn(*ts, **kw)
    (out * torch.from_numpy(np.asarray(cot))).sum().backward()
    return out.detach().numpy(), [ts[i].grad.numpy() for i in argnums]


def close(got, want, tol, what=''):
    """Every entry within ``tol`` of the largest entry of ``want`` (at
    least 1)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) if got.size else 0.0
    assert err <= tol * max(float(np.abs(want).max()) if want.size else 0,
                            1.0), (what, err)


def boxes(rs, n, scale=1.0, min_size=0.05):
    """``n`` xyxy boxes inside [0, scale]^2 with sides >= min_size x
    scale (float32)."""
    xy = rs.rand(n, 2) * (1 - min_size)
    wh = min_size + rs.rand(n, 2) * (1 - min_size - xy)
    wh = np.minimum(wh, 1 - xy)
    return (np.concatenate([xy, xy + wh], 1) * scale).astype(np.float32)


def ssd_inputs(rs, B=2, P=24, C=5, G=4):
    """An SSD loss's inputs: location (B, P, 4), confidence (B, P, C),
    ground truth (B, G, 4) and labels (B, G) near the priors (the last
    row of image 1 padding), priors (P, 4) and variances (P, 4)."""
    prior = boxes(rs, P, min_size=0.1)
    var = np.tile(np.array([0.1, 0.1, 0.2, 0.2], np.float32), (P, 1))
    gt = np.stack([prior[rs.permutation(P)[:G]] * 0.9 + 0.04
                   for _ in range(B)]).astype(np.float32)
    lab = rs.randint(1, C, (B, G)).astype(np.int32)
    gt[1, -1] = 0.0
    lab[1, -1] = -1
    loc = (0.5 * rs.randn(B, P, 4)).astype(np.float32)
    conf = rs.randn(B, P, C).astype(np.float32)
    return loc, conf, gt, lab, prior, var


# ---------------------------------------------------------------------------
# the SSD of chip_smoke.py, small, on both sides
# ---------------------------------------------------------------------------

SSD_IMAGE, SSD_SCALE, SSD_CLASSES, SSD_BATCH = 96, 0.25, 5, 4


def ssd_pair():
    """(reference network, port network, their shared state, a batch) for
    ``chip_smoke.SSDMobileNet`` at MobileNetV1 ``scale=0.25``, 96 x 96, 5
    classes (204 priors): the port's weights from its generator,
    BatchNorm's running statistics moved off their zeros and ones (a swap
    of the two would pass otherwise), carried into the same network built
    from the reference's modules, whose initializers are stubbed while it
    is built (each new shape of its random draws costs a compile: ~10 s
    for this network)."""
    import pytest

    import chip_smoke as cs
    import paddle_tpu as paddle
    import paddle_tpu.nn.initializer as jinit
    from paddle_tpu import nn as jnn
    from paddle_tpu.vision.models.mobilenetv1 import ConvBNLayer, MobileNetV1
    from paddle_tpu_torch.interop import (load_paddle_tpu_state,
                                          to_paddle_tpu_state)

    class RefSSD(jnn.Layer):
        """The SSD's network from the reference's modules, under the
        same attribute names (so the two state dicts share their keys)."""

        def __init__(self, per_cell):
            super().__init__()
            self.backbone = MobileNetV1(scale=SSD_SCALE, num_classes=0,
                                        with_pool=False)
            c = [int(512 * SSD_SCALE), int(1024 * SSD_SCALE)]
            extras = []
            for mid, out in cs.SSD_EXTRAS:
                mid, out = int(mid * SSD_SCALE), int(out * SSD_SCALE)
                extras.append(jnn.Sequential(
                    ConvBNLayer(c[-1], mid, 1, 1, 0),
                    ConvBNLayer(mid, out, 3, 2, 1)))
                c.append(out)
            self.extras = jnn.LayerList(extras)
            self.loc_heads = jnn.LayerList([
                jnn.Conv2D(ch, n * 4, 1) for ch, n in zip(c, per_cell)])
            self.conf_heads = jnn.LayerList([
                jnn.Conv2D(ch, n * SSD_CLASSES, 1)
                for ch, n in zip(c, per_cell)])

        def forward(self, x):
            feats = []
            x = self.backbone.conv1(x)
            for i, block in enumerate(self.backbone.blocks):
                x = block(x)
                if i == 10:
                    feats.append(x)
            feats.append(x)
            for extra in self.extras:
                x = extra(x)
                feats.append(x)
            locs, confs = [], []
            for f, lh, ch in zip(feats, self.loc_heads, self.conf_heads):
                b = f.shape[0]
                locs.append(lh(f).transpose([0, 2, 3, 1]).reshape(
                    [b, -1, 4]))
                confs.append(ch(f).transpose([0, 2, 3, 1]).reshape(
                    [b, -1, SSD_CLASSES]))
            return paddle.concat(locs, 1), paddle.concat(confs, 1)

    port = cs.SSDMobileNet(SSD_CLASSES, SSD_IMAGE, SSD_SCALE, device='cpu',
                           generator=torch.Generator().manual_seed(40))
    per_cell = [h.weight.shape[0] // 4 for h in port.loc_heads]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jinit.Initializer, '__call__',
                   lambda self, shape, dtype=None, key=None:
                   np.zeros(tuple(int(d) for d in shape), np.float32))
        ref = RefSSD(per_cell)
    rs = np.random.RandomState(42)
    state = {}
    for k, v in to_paddle_tpu_state(port).items():
        if k.endswith('_mean'):
            v = (0.1 * rs.randn(*v.shape)).astype(np.float32)
        elif k.endswith('_variance'):
            v = (1 + 0.2 * rs.rand(*v.shape)).astype(np.float32)
        state[k] = v
    assert set(state) == set(ref.state_dict())
    ref.set_state_dict({k: paddle.to_tensor(v) for k, v in state.items()})
    load_paddle_tpu_state(port, state)
    images = rs.randn(SSD_BATCH, 3, SSD_IMAGE, SSD_IMAGE).astype(np.float32)
    boxes, labels = cs.ssd_ground_truth(rs, SSD_BATCH, 6, SSD_CLASSES)
    return ref, port, state, (images, boxes, labels.astype(np.int32))


def ref_ssd_loss_fn(ref, priors, variances):
    """The reference's ``loss_fn(params, buffers, batch, key)``: its
    network, ``ssd_loss`` (overlap 0.5, 3 negatives a positive) summed."""
    import chip_smoke as cs
    import paddle_tpu.vision.detection_train as jdt
    from paddle_tpu.nn.layer_base import functional_call

    def loss_fn(params, buffers, batch, key=None):
        x, gt, lab = batch
        (loc, conf), new = functional_call(ref, {**params, **buffers}, JT(x))
        loss = jdt.ssd_loss(loc, conf, JT(gt), JT(lab), JT(priors),
                            JT(variances), **cs.SSD_LOSS)
        return jnp.sum(loss._value), (loc._value, conf._value), new
    return loss_fn


def close_to_max(got, want, tol, what, floor=0.0):
    """Every entry within ``tol`` of the larger of ``want``'s largest
    entry and ``floor``."""
    got, want = np.asarray(got), np.asarray(want)
    err = np.abs(got - want).max()
    scale = max(np.abs(want).max(), floor, 1e-30)
    assert err <= tol * scale, (what, err, scale)
