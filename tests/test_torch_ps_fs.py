"""``distributed.ps.SparseShardedTable`` and ``distributed.fs`` against the
reference's (``tests/test_interop_fleet.py``'s cases).

The table: one process, and two gloo ranks holding a block of rows each on
a ``'model'`` axis (``_torch_dist_ranks.table_cases``, joined within 180
s), on the reference's table (``Normal(0, 0.02)`` under ``paddle.seed``)
loaded with ``set_state_dict``; ``pull`` with a duplicate id, its
gradient, ``push`` with the duplicate accumulated. Tolerance: 1e-6
relative (rows are copies; a push adds one or two products). ``LocalFS``:
the same sequence of calls on ``tmp_path`` on both sides, every answer and
error equal. ``HDFSClient`` without a ``hadoop`` binary: the reference's
error and its negative answers.
"""
import os

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.distributed import SparseShardedTable as RTable
from paddle_tpu.distributed import fs as r_fs

from paddle_tpu_torch import distributed as t_dist
from paddle_tpu_torch.distributed import fs as t_fs

import _torch_dist_ranks as R

JOIN_S = 180
IDS = np.array([3, 7, 3, 12, 18], dtype=np.int64)
LR = 0.5


def _reference_table():
    paddle.seed(0)
    t = RTable(20, 8)
    w = np.asarray(t.weight.numpy()).copy()
    rows = t.pull(paddle.to_tensor(IDS))
    rows.sum().backward()
    grad = np.asarray(t.weight.grad.numpy()).copy()
    g = np.random.RandomState(1).randn(len(IDS), 8).astype(np.float32)
    t.push(paddle.to_tensor(IDS), paddle.to_tensor(g), lr=LR)
    return w, np.asarray(rows.numpy()), grad, g, np.asarray(t.weight.numpy())


@pytest.fixture(scope='module')
def table():
    w, rows, grad, g, after = _reference_table()
    ranks = t_dist.spawn(R.table_cases, args=(w, IDS, g, LR), nprocs=2,
                         backend='gloo', join=False).join(timeout=JOIN_S)
    return (w, rows, grad, g, after), ranks


def test_sparse_table_one_process_matches_reference(table):
    (w, rows, grad, g, after), _ = table
    t = t_dist.SparseShardedTable(20, 8, device='cpu',
                                  generator=torch.Generator().manual_seed(0))
    t.set_state_dict({'weight': w})
    got = t.pull(torch.from_numpy(IDS))
    gw, = torch.autograd.grad(got.sum(), [t.weight])
    np.testing.assert_allclose(got.detach().numpy(), rows, rtol=1e-6)
    np.testing.assert_array_equal(gw.numpy(), grad)
    t.push(torch.from_numpy(IDS), torch.from_numpy(g), lr=LR)
    np.testing.assert_allclose(t.state_dict()['weight'].numpy(), after,
                               rtol=1e-6, atol=1e-7)
    # the duplicate id took both updates
    np.testing.assert_allclose(after[3], w[3] - LR * (g[0] + g[2]),
                               rtol=1e-6)
    assert t.rows() == 20


def test_sparse_table_over_two_model_ranks_matches_reference(table):
    (w, rows, grad, g, after), ranks = table
    assert sorted(r['lo'] for r in ranks) == [0, 10]
    blocks = []
    for r in sorted(ranks, key=lambda r: r['rank']):
        np.testing.assert_allclose(r['rows'], rows, rtol=1e-6)
        np.testing.assert_allclose(r['after'], after, rtol=1e-6, atol=1e-7)
        blocks.append(r['grad'])
    np.testing.assert_array_equal(np.concatenate(blocks), grad)


def _fs_script(fs, root):
    """The same calls on either package's ``fs`` -> their answers, errors
    by class name."""
    client = fs.LocalFS()
    out = []

    def call(fn, *args, **kw):
        try:
            res = fn(*args, **kw)
        except Exception as e:   # the error's class is the answer
            return f'raises {type(e).__name__}'
        if hasattr(res, 'st_size'):
            return res.st_size
        if isinstance(res, (list, tuple)):
            res = [sorted(x) if isinstance(x, list) else x for x in res]
        return res
    a, b = os.path.join(root, 'a'), os.path.join(root, 'b')
    out.append(call(client.mkdirs, os.path.join(a, 'sub')))
    out.append(call(client.touch, os.path.join(a, 'f.txt')))
    out.append(call(client.touch, os.path.join(a, 'f.txt'), exist_ok=False))
    out.append(call(client.ls_dir, a))
    out.append(call(client.ls_dir, os.path.join(root, 'missing')))
    out.append([call(client.is_file, os.path.join(a, 'f.txt')),
                call(client.is_dir, a), call(client.is_exist, b)])
    out.append(call(client.rename, a, b))
    out.append(call(client.rename, a, b))
    out.append(call(client.mkdirs, a))
    out.append(call(client.rename, a, b))
    out.append(call(client.upload, os.path.join(b, 'f.txt'),
                    os.path.join(root, 'g.txt')))
    out.append(call(client.download, b, os.path.join(root, 'c')))
    out.append(sorted(os.path.relpath(p, root) for p in
                      client.glob(os.path.join(root, '*'))))
    out.append(call(client.stat, os.path.join(root, 'g.txt')))
    out.append(call(client.stat, os.path.join(root, 'nope')))
    out.append(call(client.list_dirs, root))
    out.append(call(client.mv, os.path.join(root, 'g.txt'),
                    os.path.join(root, 'h.txt')))
    out.append(call(client.delete, b))
    out.append(call(client.delete, os.path.join(root, 'h.txt')))
    out.append(call(client.ls_dir, root))
    out.append(call(client.need_upload_download))
    return out


def test_local_fs_matches_reference(tmp_path):
    (tmp_path / 'ref').mkdir()
    (tmp_path / 'port').mkdir()
    want = _fs_script(r_fs, str(tmp_path / 'ref'))
    got = _fs_script(t_fs, str(tmp_path / 'port'))
    assert got == want
    assert 'raises FSFileExistsError' in got
    assert 'raises FSFileNotExistsError' in got


def test_hdfs_client_without_hadoop_errors_as_reference(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv('PATH', str(tmp_path))
    for fs in (r_fs, t_fs):
        client = fs.HDFSClient(sleep_inter=1)
        with pytest.raises(fs.ExecuteError, match='no hadoop binary'):
            client.ls_dir('/x')
        with pytest.raises(fs.ExecuteError, match='no hadoop binary'):
            client.mkdirs('/x')
        assert client.is_exist('/x') is False
        assert client.is_dir('/x') is False
        assert client.is_file('/x') is False
        assert client.need_upload_download() is True
    assert issubclass(t_fs.FSShellCmdAborted, t_fs.ExecuteError)
    assert [c.__name__ for c in (t_fs.FSFileExistsError,
                                 t_fs.FSFileNotExistsError, t_fs.FSTimeOut)] \
        == [c.__name__ for c in (r_fs.FSFileExistsError,
                                 r_fs.FSFileNotExistsError, r_fs.FSTimeOut)]
