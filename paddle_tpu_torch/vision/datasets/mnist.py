"""MNIST / FashionMNIST. The port's copy of
``paddle_tpu/vision/datasets/mnist.py``.

Reads local IDX files if present; nothing downloads. Otherwise it makes a
deterministic synthetic set, flagged ``.synthetic``.
"""
import gzip
import os
import struct

import numpy as np

from ...io import Dataset

__all__ = ['MNIST', 'FashionMNIST']


def _load_idx_images(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic, n, rows, cols = struct.unpack('>IIII', f.read(16))
        data = np.frombuffer(f.read(), dtype=np.uint8)
        return data.reshape(n, rows, cols)


def _load_idx_labels(path):
    opener = gzip.open if path.endswith('.gz') else open
    with opener(path, 'rb') as f:
        magic, n = struct.unpack('>II', f.read(8))
        return np.frombuffer(f.read(), dtype=np.uint8)


def _synthetic_mnist(n, seed):
    """Deterministic digit-like images: class-dependent stripe patterns."""
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, 10, size=n).astype(np.int64)
    images = np.zeros((n, 28, 28), dtype=np.uint8)
    yy, xx = np.mgrid[0:28, 0:28]
    for i in range(n):
        c = labels[i]
        base = (np.sin(xx * (c + 1) * 0.35) * np.cos(yy * (c + 2) * 0.25) + 1)
        noise = rng.rand(28, 28) * 0.3
        img = (base / 2 + noise)
        img = (img / img.max() * 255).astype(np.uint8)
        images[i] = img
    return images, labels


class MNIST(Dataset):
    NAME = 'mnist'

    def __init__(self, image_path=None, label_path=None, mode='train',
                 transform=None, download=True, backend='cv2'):
        self.mode = mode.lower()
        self.transform = transform
        self.synthetic = False
        root = os.environ.get('PADDLE_TPU_DATA_HOME',
                              os.path.expanduser('~/.cache/paddle_tpu'))
        prefix = 'train' if self.mode == 'train' else 't10k'
        candidates = [
            (image_path, label_path),
            (os.path.join(root, self.NAME, f'{prefix}-images-idx3-ubyte.gz'),
             os.path.join(root, self.NAME, f'{prefix}-labels-idx1-ubyte.gz')),
            (os.path.join(root, self.NAME, f'{prefix}-images-idx3-ubyte'),
             os.path.join(root, self.NAME, f'{prefix}-labels-idx1-ubyte')),
        ]
        for ip, lp in candidates:
            if ip and lp and os.path.exists(ip) and os.path.exists(lp):
                self.images = _load_idx_images(ip)
                self.labels = _load_idx_labels(lp).astype(np.int64)
                break
        else:
            n = 2048 if self.mode == 'train' else 512
            self.images, self.labels = _synthetic_mnist(
                n, seed=0 if self.mode == 'train' else 1)
            self.synthetic = True

    def __getitem__(self, idx):
        img = self.images[idx]
        label = self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32)[None, :, :] / 255.0
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        return len(self.images)


class FashionMNIST(MNIST):
    NAME = 'fashion-mnist'
