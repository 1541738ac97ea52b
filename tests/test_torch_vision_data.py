"""The port's ``vision.transforms`` and ``vision.datasets`` against the JAX
package's (both numpy), value for value.

- Every transform functional on a uint8 and a float image: equal arrays.
- The transform classes; the random ones draw from ``rng=``: a port
  transform given ``random.Random(s)`` (or ``np.random.RandomState(s)``)
  equals the reference's after ``random.seed(s)`` (``np.random.seed(s)``),
  call after call.
- The synthetic datasets (MNIST, FashionMNIST, Cifar10/100, Flowers,
  VOC2012): the same ``.synthetic`` flag, length and samples; MNIST read
  from local IDX files and ``DatasetFolder`` / ``ImageFolder`` over
  ``.npy`` files: the same samples.
"""
import gzip
import random
import struct

import numpy as np
import pytest

import paddle_tpu.vision.datasets as jds
import paddle_tpu.vision.transforms as jtr
import paddle_tpu.vision.transforms.functional as jF

import paddle_tpu_torch.vision.datasets as tds
import paddle_tpu_torch.vision.transforms as ttr
import paddle_tpu_torch.vision.transforms.functional as tF


def _img(seed, float_=False, shape=(12, 10, 3)):
    rs = np.random.RandomState(seed)
    if float_:
        return rs.rand(*shape).astype(np.float32)
    return rs.randint(0, 256, shape).astype(np.uint8)


def _eq(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


FUNCTIONALS = [
    ('to_tensor', ()), ('to_tensor', ('HWC',)), ('resize', ((7, 9),)),
    ('resize', (6,)), ('crop', (1, 2, 5, 4)), ('center_crop', (6,)),
    ('hflip', ()), ('vflip', ()),
    ('normalize', ([0.5, 0.4, 0.3], [0.2, 0.3, 0.4], 'HWC')),
    ('pad', (2,)), ('pad', ((1, 2), 3, 'edge')),
    ('pad', ((1, 2, 3, 4), 0, 'reflect')), ('rotate', (30,)),
    ('rotate', (-45, 'nearest', False, (3, 4), 7)),
    ('adjust_brightness', (1.3,)), ('adjust_contrast', (0.7,)),
    ('adjust_saturation', (1.5,)), ('adjust_hue', (0.1,)),
    ('to_grayscale', ()), ('to_grayscale', (3,)),
    ('transpose_img', ((2, 0, 1),)),
]


@pytest.mark.parametrize('float_', [False, True])
@pytest.mark.parametrize('case', range(len(FUNCTIONALS)))
def test_transform_functionals_match_reference(case, float_):
    name, args = FUNCTIONALS[case]
    img = _img(case, float_)
    _eq(getattr(tF, name)(img, *args), getattr(jF, name)(img, *args))


def test_flip_and_normalize_chw():
    img = _img(1)
    for code in (0, 1, -1):
        _eq(ttr.flip(img, code), jtr.flip(img, code))
    chw = _img(2, True).transpose(2, 0, 1)
    _eq(ttr.normalize(chw, [0.1, 0.2, 0.3], [1, 2, 3]),
        jtr.normalize(chw, [0.1, 0.2, 0.3], [1, 2, 3]))


def _pipeline(mod):
    return mod.Compose([mod.Resize((16, 14)), mod.CenterCrop(12),
                        mod.Pad(1), mod.Grayscale(3), mod.Transpose(),
                        mod.Normalize(0.5, 0.25)])


def test_deterministic_transform_classes_match_reference():
    img = _img(3)
    _eq(_pipeline(ttr)(img), _pipeline(jtr)(img))
    _eq(ttr.ToTensor()(img), jtr.ToTensor()(img))
    _eq(ttr.CenterCropResize(8)(img), jtr.CenterCropResize(8)(img))
    _eq(ttr.Permute()(img), jtr.Permute()(img))
    batch = [img, _img(4)]
    got = ttr.BatchCompose([ttr.Resize(5)])(batch)
    want = jtr.BatchCompose([jtr.Resize(5)])(batch)
    for a, b in zip(got, want):
        _eq(a, b)


RANDOM_PY = [
    ('RandomResizedCrop', (8,), {}),
    ('RandomCrop', (8,), {'padding': 2}),
    ('RandomCrop', (14,), {'pad_if_needed': True}),
    ('RandomHorizontalFlip', (), {}),
    ('RandomVerticalFlip', (), {}),
    ('BrightnessTransform', (0.4,), {}),
    ('ContrastTransform', (0.4,), {}),
    ('SaturationTransform', (0.4,), {}),
    ('HueTransform', (0.2,), {}),
    ('ColorJitter', (0.4, 0.4, 0.4, 0.1), {}),
    ('RandomRotation', (40,), {}),
]


@pytest.mark.parametrize('case', range(len(RANDOM_PY)))
def test_random_transforms_match_reference_from_one_seed(case):
    name, args, kw = RANDOM_PY[case]
    port = getattr(ttr, name)(*args, rng=random.Random(case), **kw)
    ref = getattr(jtr, name)(*args, **kw)
    random.seed(case)
    for i in range(6):
        img = _img(10 + i)
        _eq(port(img), ref(img))


def test_numpy_random_transforms_match_reference_from_one_seed():
    for name, kw in (('GaussianNoise', {'variance': 4.0}),
                     ('RandomErasing', {'prob': 0.7, 'value': 9})):
        port = getattr(ttr, name)(rng=np.random.RandomState(5), **kw)
        ref = getattr(jtr, name)(**kw)
        np.random.seed(5)
        for i in range(6):
            img = _img(20 + i, name == 'GaussianNoise')
            _eq(port(img), ref(img))


@pytest.mark.parametrize('name,kw', [
    ('MNIST', {'mode': 'test'}), ('FashionMNIST', {'mode': 'train'}),
    ('Cifar10', {'mode': 'test'}), ('Cifar100', {'mode': 'test'}),
    ('Flowers', {'mode': 'valid'}), ('VOC2012', {'mode': 'test'}),
])
def test_synthetic_datasets_match_reference(name, kw, tmp_path, monkeypatch):
    monkeypatch.setenv('PADDLE_TPU_DATA_HOME', str(tmp_path))
    port, ref = getattr(tds, name)(**kw), getattr(jds, name)(**kw)
    assert port.synthetic and ref.synthetic
    assert len(port) == len(ref)
    for i in (0, 1, len(ref) // 2, len(ref) - 1):
        for a, b in zip(port[i], ref[i]):
            _eq(a, b)
    tr = ttr.Compose([ttr.Resize(8), ttr.ToTensor()])
    jt = jtr.Compose([jtr.Resize(8), jtr.ToTensor()])
    _eq(getattr(tds, name)(transform=tr, **kw)[3][0],
        getattr(jds, name)(transform=jt, **kw)[3][0])


def _write_idx(path, images, labels):
    with gzip.open(path + '-images.gz', 'wb') as f:
        f.write(struct.pack('>IIII', 2051, len(images), 28, 28))
        f.write(images.tobytes())
    with gzip.open(path + '-labels.gz', 'wb') as f:
        f.write(struct.pack('>II', 2049, len(labels)))
        f.write(labels.tobytes())


def test_local_files_are_read_as_the_reference_reads_them(tmp_path):
    rs = np.random.RandomState(6)
    images = rs.randint(0, 256, (5, 28, 28)).astype(np.uint8)
    labels = rs.randint(0, 10, 5).astype(np.uint8)
    base = str(tmp_path / 'mnist')
    _write_idx(base, images, labels)
    kw = dict(image_path=base + '-images.gz',
              label_path=base + '-labels.gz', mode='train')
    port, ref = tds.MNIST(**kw), jds.MNIST(**kw)
    assert not port.synthetic and not ref.synthetic and len(port) == 5
    for i in range(5):
        for a, b in zip(port[i], ref[i]):
            _eq(a, b)
    root = tmp_path / 'folder'
    for c in ('cat', 'dog'):
        (root / c).mkdir(parents=True)
        for j in range(2):
            np.save(root / c / f'{j}.npy', _img(30 + j))
    (root / 'dog' / 'skip.txt').write_text('not an image')
    for cls in ('DatasetFolder', 'ImageFolder'):
        port, ref = getattr(tds, cls)(str(root)), getattr(jds, cls)(
            str(root))
        assert len(port) == len(ref) == 4
        for i in range(4):
            got, want = port[i], ref[i]
            _eq(got[0], want[0])
            if cls == 'DatasetFolder':
                assert got[1] == want[1]
    assert tds.DatasetFolder(str(root)).classes == ['cat', 'dog']
