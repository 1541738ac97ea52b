"""``text.datasets`` against the JAX package.

With no corpus on disk (``DATA_HOME`` pointed at an empty directory on
both sides), every synthetic set gives the reference's arrays exactly,
item by item, for each mode; its seed is the ``crc32`` of its class name
and mode, so a second construction repeats them. With files in the
reference's layouts under ``DATA_HOME`` (a small ``housing.data``, a
Multi30k-style ``wmt16.tar.gz``), both packages' local loaders read the
same values. Nothing is downloaded.
"""
import io
import os
import tarfile

import numpy as np
import pytest

from paddle_tpu.text import datasets as jds
from paddle_tpu.text.datasets import real as jreal

from paddle_tpu_torch import io as tio
from paddle_tpu_torch import text
from paddle_tpu_torch.text import datasets as tds
from paddle_tpu_torch.text.datasets import real as treal

CASES = [('Imdb', {}), ('Imikolov', {}), ('Imikolov', {'window_size': 3}),
         ('Movielens', {}), ('UCIHousing', {}), ('WMT14', {}),
         ('WMT14', {'dict_size': 500}), ('WMT16', {}), ('Conll05st', {}),
         ('MQ2007', {}), ('MQ2007', {'mode': 'pairwise'}), ('Sentiment', {})]


@pytest.fixture
def empty_home(tmp_path, monkeypatch):
    monkeypatch.setattr(jreal, 'DATA_HOME', str(tmp_path))
    monkeypatch.setattr(treal, 'DATA_HOME', str(tmp_path))
    return tmp_path


def _equal(a, b):
    if isinstance(a, (tuple, list)):
        assert isinstance(b, (tuple, list)) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _items(ds, n=None):
    idx = range(len(ds)) if n is None else \
        sorted({0, 1, len(ds) // 2, len(ds) - 1})
    return [ds[i] for i in idx]


@pytest.mark.parametrize('name,kw', CASES)
@pytest.mark.parametrize('mode', ['train', 'test'])
def test_synthetic_sets_equal_reference(empty_home, name, kw, mode):
    kw = dict(kw)
    if name != 'MQ2007':
        kw['mode'] = mode
    want = getattr(jds, name)(**kw)
    got = getattr(tds, name)(**kw)
    assert isinstance(got, tio.Dataset)
    assert got.synthetic and want.synthetic
    assert len(got) == len(want)
    _equal(_items(got, 4), _items(want, 4))
    again = getattr(tds, name)(**kw)
    _equal(_items(again, 4), _items(got, 4))


def test_whole_wmt16_set_equals_reference(empty_home):
    want, got = jds.WMT16('train'), tds.WMT16('train')
    _equal(_items(got), _items(want))
    src, trg, nxt = got[3]
    np.testing.assert_array_equal(trg, np.roll(src, 1))
    np.testing.assert_array_equal(nxt, np.roll(trg, -1))
    assert src.max() < 10000


def test_text_exports_the_dataset_classes():
    for name in ('Conll05st', 'Imdb', 'Imikolov', 'Movielens', 'UCIHousing',
                 'WMT14', 'WMT16', 'MQ2007', 'Sentiment'):
        assert getattr(text, name) is getattr(tds, name)
    assert text.MovieReviews is tds.Sentiment


def test_local_uci_housing_equals_reference(empty_home):
    rs = np.random.RandomState(0)
    rows = rs.rand(30, 14) * 10
    os.makedirs(empty_home / 'uci_housing')
    np.savetxt(empty_home / 'uci_housing' / 'housing.data', rows)
    for mode in ('train', 'test'):
        want, got = jds.UCIHousing(mode), tds.UCIHousing(mode)
        assert not got.synthetic and len(got) == len(want)
        _equal(_items(got), _items(want))


def _add(tf, name, text_):
    data = text_.encode()
    info = tarfile.TarInfo(name)
    info.size = len(data)
    tf.addfile(info, io.BytesIO(data))


def test_local_wmt16_equals_reference(empty_home):
    os.makedirs(empty_home / 'wmt16')
    en = ['a small dog runs', 'the cat sleeps', 'a dog and a cat']
    de = ['ein kleiner hund rennt', 'die katze schlaeft',
          'ein hund und eine katze']
    with tarfile.open(empty_home / 'wmt16' / 'wmt16.tar.gz', 'w:gz') as tf:
        for split in ('train', 'test', 'val'):
            _add(tf, f'wmt16/{split}',
                 '\n'.join(f'{e}\t{d}' for e, d in zip(en, de)) + '\n')
    want = jds.WMT16('train', src_dict_size=20, trg_dict_size=20)
    got = tds.WMT16('train', src_dict_size=20, trg_dict_size=20)
    assert not got.synthetic and not want.synthetic
    assert len(got) == len(want) == 3
    _equal(_items(got), _items(want))
