"""Every function of ``nn/functional/extension.py`` against the JAX
package on the same numpy inputs (small shapes, fp32, lengths that
include 0 and the full length). Float outputs within 1e-6 of their
largest entry (the same elementwise products and sums, in the same
order up to a reduction's); integer and mask outputs exactly. The
sequence ops' gradients go through the port's autograd and are checked
where the op is differentiable.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.nn.functional import extension as jext

from paddle_tpu_torch.nn import functional as TF
from paddle_tpu_torch.nn.functional import extension as text

TOL = 1e-6
LENGTHS = np.array([4, 0, 6, 1], np.int64)


def _np(t):
    return np.asarray(t._value)


def _close(got, want, tol=TOL):
    got = got.detach().numpy()
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(np.abs(want).max(), 1.0)
    assert np.abs(got - want).max() <= tol * scale


@pytest.fixture(scope='module')
def x3():
    return np.random.RandomState(0).randn(4, 6, 3).astype(np.float32)


def test_every_name_is_exported():
    assert set(text.__all__) == set(jext.__all__)
    for name in text.__all__:
        assert getattr(TF, name) is getattr(text, name)


@pytest.mark.parametrize('offset,dim1,dim2', [(0, -2, -1), (1, -2, -1),
                                              (-2, -2, -1), (0, 0, 2),
                                              (1, 1, 0)])
def test_diag_embed(offset, dim1, dim2):
    x = np.random.RandomState(1).randn(2, 3, 4).astype(np.float32)
    want = jext.diag_embed(paddle.to_tensor(x), offset, dim1, dim2)
    got = text.diag_embed(torch.from_numpy(x), offset, dim1, dim2)
    _close(got, _np(want))


@pytest.mark.parametrize('maxlen,dtype', [(None, 'int64'), (8, 'float32'),
                                          (5, 'bool')])
def test_sequence_mask(maxlen, dtype):
    lengths = np.array([[3, 0], [5, 2]], np.int64)
    want = jext.sequence_mask(paddle.to_tensor(lengths), maxlen, dtype)
    got = text.sequence_mask(torch.from_numpy(lengths), maxlen, dtype)
    assert str(got.dtype).endswith(dtype)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    tensor_max = text.sequence_mask(torch.from_numpy(lengths),
                                    torch.tensor(6))
    assert tensor_max.shape == (2, 2, 6)


@pytest.mark.parametrize('fmt,ratio', [('NCHW', 0.25), ('NHWC', 0.125),
                                       ('NCHW', 0.5)])
def test_temporal_shift(fmt, ratio):
    x = np.random.RandomState(2).randn(6, 8, 3, 2).astype(np.float32)
    if fmt == 'NHWC':
        x = x.transpose(0, 2, 3, 1).copy()
    want = jext.temporal_shift(paddle.to_tensor(x), 3, ratio, fmt)
    got = text.temporal_shift(torch.from_numpy(x), 3, ratio, fmt)
    _close(got, _np(want))


POOLS = ['sum', 'average', 'sqrt', 'max', 'first', 'last']


@pytest.mark.parametrize('pool', POOLS)
def test_sequence_pool(x3, pool):
    want = _np(jext.sequence_pool(paddle.to_tensor(x3), pool,
                                  paddle.to_tensor(LENGTHS)))
    x = torch.from_numpy(x3).requires_grad_()
    got = text.sequence_pool(x, pool, torch.from_numpy(LENGTHS))
    # the sequences that are not empty (row 1 is: see the fault below)
    full = LENGTHS > 0
    _close(got[torch.from_numpy(full)], want[full])
    assert (got[1] == 0).all()
    got.sum().backward()
    if pool in ('sum', 'average', 'sqrt'):
        # padded steps get no gradient
        assert (x.grad[0, 4:] == 0).all() and (x.grad[1] == 0).all()
    full = jext.sequence_pool(paddle.to_tensor(x3), pool)
    _close(text.sequence_pool(torch.from_numpy(x3), pool), _np(full))


@pytest.mark.parametrize('pool', POOLS)
def test_reference_fault_sequence_pool_ignores_pad_value(x3, pool):
    """The reference's ``sequence_pool`` accepts ``pad_value`` and never
    uses it (``paddle_tpu/nn/functional/extension.py:86-113``): an empty
    sequence pools to 0 for the sums, -1e30 for ``max`` and step 0 for
    ``first``/``last``. Upstream Paddle's ``sequence_pool`` gives
    ``pad_value`` for an empty sequence; the port does."""
    lengths = paddle.to_tensor(LENGTHS)
    want = _np(jext.sequence_pool(paddle.to_tensor(x3), pool, lengths,
                                  pad_value=7.0))
    got = text.sequence_pool(torch.from_numpy(x3), pool,
                             torch.from_numpy(LENGTHS), pad_value=7.0)
    assert (got[1] == 7.0).all()
    assert not (want[1] == 7.0).any()
    full = LENGTHS > 0
    _close(got[torch.from_numpy(full)], want[full])


def test_sequence_pool_rejects_an_unknown_type(x3):
    with pytest.raises(ValueError):
        text.sequence_pool(torch.from_numpy(x3), 'median')


def test_sequence_softmax():
    x = np.random.RandomState(3).randn(4, 6).astype(np.float32)
    lengths = np.array([4, 1, 6, 2], np.int64)
    want = jext.sequence_softmax(paddle.to_tensor(x),
                                 paddle.to_tensor(lengths))
    got = text.sequence_softmax(torch.from_numpy(x),
                                torch.from_numpy(lengths))
    _close(got, _np(want))
    _close(text.sequence_softmax(torch.from_numpy(x)),
           _np(jext.sequence_softmax(paddle.to_tensor(x))))


@pytest.mark.parametrize('maxlen', [None, 9])
def test_sequence_pad(x3, maxlen):
    want, wlen = jext.sequence_pad(paddle.to_tensor(x3), -2.5, maxlen,
                                   paddle.to_tensor(LENGTHS))
    got, glen = text.sequence_pad(torch.from_numpy(x3), torch.tensor(-2.5),
                                  maxlen, torch.from_numpy(LENGTHS))
    _close(got, _np(want))
    np.testing.assert_array_equal(glen.numpy(), _np(wlen))


def test_sequence_unpad(x3):
    want = jext.sequence_unpad(paddle.to_tensor(x3),
                               paddle.to_tensor(LENGTHS))
    got = text.sequence_unpad(torch.from_numpy(x3),
                              torch.from_numpy(LENGTHS))
    _close(got, _np(want))


def test_sequence_expand(x3):
    reps = np.array([2, 0, 1, 3], np.int64)
    want = jext.sequence_expand(paddle.to_tensor(x3), paddle.to_tensor(reps))
    got = text.sequence_expand(torch.from_numpy(x3), torch.from_numpy(reps))
    _close(got, _np(want))
    assert got.shape[0] == 6


@pytest.mark.parametrize('with_length', [False, True])
def test_sequence_reverse(x3, with_length):
    length = LENGTHS if with_length else None
    want = jext.sequence_reverse(
        paddle.to_tensor(x3),
        None if length is None else paddle.to_tensor(length))
    got = text.sequence_reverse(
        torch.from_numpy(x3),
        None if length is None else torch.from_numpy(length))
    _close(got, _np(want))


def test_sequence_concat(x3):
    y = np.random.RandomState(4).randn(4, 2, 3).astype(np.float32)
    want = jext.sequence_concat([paddle.to_tensor(x3), paddle.to_tensor(y)])
    got = text.sequence_concat([torch.from_numpy(x3), torch.from_numpy(y)])
    _close(got, _np(want))


def test_gather_tree():
    rs = np.random.RandomState(5)
    ids = rs.randint(0, 30, (7, 3, 4)).astype(np.int64)
    parents = rs.randint(0, 4, (7, 3, 4)).astype(np.int64)
    want = jext.gather_tree(paddle.to_tensor(ids), paddle.to_tensor(parents))
    got = text.gather_tree(torch.from_numpy(ids), torch.from_numpy(parents))
    np.testing.assert_array_equal(got.numpy(), _np(want))
