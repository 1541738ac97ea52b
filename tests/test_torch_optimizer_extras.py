"""``paddle_tpu_torch.optimizer.extras`` against
``paddle_tpu.optimizer.extras``: ``ExponentialMovingAverage``,
``LookAhead`` and ``ModelAverage`` over 6 eager steps of the same
``Linear`` on the same weights and batches (the reference's gradients and
the port's agree within fp32 rounding), held to 1e-6 of each tensor's
largest value, with their ``apply`` / ``restore``; LookAhead's slow weights
are clones that move only every k steps (the reference stores the
parameter's value, an immutable array there, which in torch would alias
the live parameter); and the Recompute wrapper's run equals the plain run
bit for bit, dropout included, with its checkpointed modules recomputed.
``PipelineOptimizer`` raises naming ``distributed/``."""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu import nn as jnn
from paddle_tpu import optimizer as jopt
from paddle_tpu.optimizer import extras as jextras

from paddle_tpu_torch import nn as tnn
from paddle_tpu_torch import optimizer as topt
from paddle_tpu_torch.kernels.philox import DropoutState
from paddle_tpu_torch.optimizer import extras as textras

STEPS = 6


def _data():
    rs = np.random.RandomState(0)
    return [(rs.randn(8, 5).astype(np.float32),
             rs.randn(8, 3).astype(np.float32)) for _ in range(STEPS)]


def _pair(opt_cls=('SGD', dict(learning_rate=0.1))):
    """The reference's and the port's ``Linear(5, 3)`` on the same weights,
    each with its eager optimizer."""
    paddle.seed(2)
    ref = jnn.Linear(5, 3)
    port = tnn.Linear(5, 3, device='cpu')
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(np.array(ref.weight._value).T))
        port.bias.copy_(torch.from_numpy(np.array(ref.bias._value)))
    name, kw = opt_cls
    ropt = getattr(jopt, name)(parameters=ref.parameters(), **kw)
    popt = getattr(topt, name)(parameters=port.named_parameters(), **kw)
    return ref, port, ropt, popt


def _ref_loss(ref, x, y):
    d = ref(paddle.to_tensor(x)) - paddle.to_tensor(y)
    return (d * d).mean()


def _port_loss(port, x, y):
    d = port(torch.from_numpy(x)) - torch.from_numpy(y)
    return (d * d).mean()


def _step(ref, port, ropt, popt, x, y):
    ropt.minimize(_ref_loss(ref, x, y))
    popt.minimize(_port_loss(port, x, y))


def _values(ref, port):
    """((ref weight (in, out), bias), (port weight transposed, bias))."""
    return ((np.asarray(ref.weight._value), np.asarray(ref.bias._value)),
            (port.weight.detach().numpy().T.copy(),
             port.bias.detach().numpy().copy()))


def _close(got, want):
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= 1e-6 * max(np.abs(w).max(), 1.0)


def test_ema_matches_the_reference_with_apply_and_restore():
    ref, port, ropt, popt = _pair()
    rema, pema = jextras.ExponentialMovingAverage(0.9), \
        textras.ExponentialMovingAverage(0.9)
    for x, y in _data():
        _step(ref, port, ropt, popt, x, y)
        rema.update(ref.parameters())
        pema.update(port.parameters())
        ref_shadow = [np.asarray(rema._shadow[id(p)])
                      for p in ref.parameters()]
        _close([pema._shadow[0].numpy().T, pema._shadow[1].numpy()],
               ref_shadow)
    live = _values(ref, port)
    with rema.apply(), pema.apply():
        applied = _values(ref, port)
        _close(applied[1], applied[0])
        _close(applied[1], [pema._shadow[0].numpy().T,
                            pema._shadow[1].numpy()])
        assert not np.array_equal(applied[1][0], live[1][0])
    _close(_values(ref, port)[1], live[1])
    assert np.array_equal(_values(ref, port)[1][0], live[1][0])
    assert pema.apply(need_restore=False) is None
    pema.restore()
    assert np.array_equal(_values(ref, port)[1][0], live[1][0])


def test_lookahead_matches_the_reference():
    ref, port, ropt, popt = _pair(('Adam', dict(learning_rate=0.05)))
    rla = jextras.LookAhead(ropt, alpha=0.5, k=3)
    pla = textras.LookAhead(popt, alpha=0.5, k=3)
    for x, y in _data():
        rla.minimize(_ref_loss(ref, x, y))
        pla.minimize(_port_loss(port, x, y))
        got = _values(ref, port)
        _close(got[1], got[0])
    assert pla.state_dict().keys() == popt.state_dict().keys()


def test_lookahead_slow_weights_are_clones_that_move_every_k_steps():
    _, port, _, popt = _pair()
    la = textras.LookAhead(popt, alpha=0.5, k=3)
    slow_seen = []
    for i, (x, y) in enumerate(_data()):
        la.minimize(_port_loss(port, x, y))
        slow = [s.clone() for s in la._slow]
        slow_seen.append(slow)
        for s, p in zip(la._slow, port.parameters()):
            assert s.data_ptr() != p.data_ptr()
        if (i + 1) % 3 == 0:
            # the sync: the fast weights are set to the slow ones
            for s, p in zip(la._slow, port.parameters()):
                assert torch.equal(s, p.detach())
    # the slow weights change only at steps 3 and 6 (the first step sets
    # them), while the fast weights move every step
    for i in range(1, STEPS):
        moved = not all(torch.equal(a, b) for a, b in
                        zip(slow_seen[i], slow_seen[i - 1]))
        assert moved == ((i + 1) % 3 == 0), i


def test_model_average_matches_the_reference():
    ref, port, ropt, popt = _pair()
    rma = jextras.ModelAverage(parameters=ref.parameters())
    pma = textras.ModelAverage(parameters=port.named_parameters())
    for x, y in _data():
        _step(ref, port, ropt, popt, x, y)
        rma.step()
        pma.step()
    live = _values(ref, port)
    with rma.apply(), pma.apply():
        got = _values(ref, port)
        _close(got[1], got[0])
        assert not np.array_equal(got[1][0], live[1][0])
    assert np.array_equal(_values(ref, port)[1][0], live[1][0])


class _Block(torch.nn.Module):
    def __init__(self, state, generator):
        super().__init__()
        self.lin = tnn.Linear(16, 16, device='cpu', generator=generator)
        self.drop = tnn.Dropout(0.1, dropout_state=state)

    def forward(self, x):
        return self.drop(torch.tanh(self.lin(x)))


def _recompute_run(recompute):
    g = torch.Generator().manual_seed(4)
    state = DropoutState(99)
    blocks = torch.nn.ModuleList([_Block(state, g) for _ in range(2)])
    opt = topt.Adam(learning_rate=0.01,
                    parameters=blocks.named_parameters())
    if recompute:
        opt = textras.RecomputeOptimizer(opt)
        opt._set_checkpoints(list(blocks) + ['a name, kept for show'])
    rs = np.random.RandomState(1)
    losses = []
    for _ in range(3):
        x = torch.from_numpy(rs.randn(4, 16).astype(np.float32))
        h = x
        for b in blocks:
            h = b(h)
        loss = (h * h).mean()
        opt.minimize(loss)
        losses.append(float(loss.detach()))
    return blocks, opt, losses


def test_recompute_wrapper_equals_the_plain_run():
    plain, _, want = _recompute_run(False)
    got_blocks, opt, got = _recompute_run(True)
    assert got == want
    for a, b in zip(plain.parameters(), got_blocks.parameters()):
        assert torch.equal(a, b)
    assert opt.remat.calls == 6          # 2 blocks x 3 steps
    assert opt.get_lr() == 0.01           # the inner optimizer's API
    with torch.no_grad():                 # no recompute without gradients
        got_blocks[0](torch.zeros(1, 16))
    assert opt.remat.calls == 6
    with pytest.raises(ValueError, match='list or tuple'):
        opt._set_checkpoints('lin')
    with pytest.raises(NotImplementedError):
        opt.load({})


def test_pipeline_optimizer_raises_naming_distributed():
    """The reference's wrapper: its configuration errors, word for word,
    and the inner optimizer's API (the pipeline itself is
    distributed.pipeline_apply: tests/test_torch_pipeline.py)."""
    from paddle_tpu.optimizer import extras as rextras
    for kw in ({'num_microbatches': 0}, {'start_cpu_core_id': -1}):
        errors = []
        for mod in (rextras, textras):
            with pytest.raises(ValueError) as e:
                mod.PipelineOptimizer(object(), **kw)
            errors.append(str(e.value))
        assert errors[0] == errors[1]
    w = torch.nn.Parameter(torch.tensor([1.0, 2.0]))
    opt = textras.PipelineOptimizer(
        topt.SGD(learning_rate=0.5, parameters=[w]), num_microbatches=4)
    assert opt._num_microbatches == 4
    assert opt.get_lr() == 0.5
    opt.minimize((w ** 2).sum())
    assert torch.equal(w.detach(), torch.tensor([0.0, 0.0]))
