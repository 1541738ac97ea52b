"""CIFAR10/100. The port's copy of ``paddle_tpu/vision/datasets/cifar.py``.

Local pickle archives if present; deterministic synthetic fallback otherwise.
"""
import os
import pickle
import tarfile

import numpy as np

from ...io import Dataset

__all__ = ['Cifar10', 'Cifar100']


def _synthetic(n, num_classes, seed):
    rng = np.random.RandomState(seed)
    labels = rng.randint(0, num_classes, size=n).astype(np.int64)
    images = np.zeros((n, 32, 32, 3), dtype=np.uint8)
    yy, xx = np.mgrid[0:32, 0:32]
    for i in range(n):
        c = labels[i] % 16
        base = np.stack([
            np.sin(xx * (c + 1) * 0.2),
            np.cos(yy * (c + 2) * 0.2),
            np.sin((xx + yy) * (c + 3) * 0.1)], axis=-1)
        img = (base + 1) / 2 + rng.rand(32, 32, 3) * 0.2
        images[i] = (img / img.max() * 255).astype(np.uint8)
    return images, labels


class Cifar10(Dataset):
    NUM_CLASSES = 10

    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend='cv2'):
        self.mode = mode.lower()
        self.transform = transform
        self.synthetic = False
        root = os.environ.get('PADDLE_TPU_DATA_HOME',
                              os.path.expanduser('~/.cache/paddle_tpu'))
        archive = data_file or os.path.join(
            root, 'cifar',
            'cifar-10-python.tar.gz' if self.NUM_CLASSES == 10 else
            'cifar-100-python.tar.gz')
        if os.path.exists(archive):
            self.images, self.labels = self._load_archive(archive)
        else:
            n = 2048 if self.mode == 'train' else 512
            self.images, self.labels = _synthetic(
                n, self.NUM_CLASSES, 0 if self.mode == 'train' else 1)
            self.synthetic = True

    def _load_archive(self, path):
        images, labels = [], []
        with tarfile.open(path) as tf:
            for member in tf.getmembers():
                name = os.path.basename(member.name)
                want = ('data_batch' in name if self.mode == 'train'
                        else 'test_batch' in name) if self.NUM_CLASSES == 10 \
                    else (name == ('train' if self.mode == 'train' else 'test'))
                if not want:
                    continue
                d = pickle.load(tf.extractfile(member), encoding='bytes')
                images.append(d[b'data'])
                key = b'labels' if b'labels' in d else b'fine_labels'
                labels.extend(d[key])
        data = np.concatenate(images).reshape(-1, 3, 32, 32)
        return data.transpose(0, 2, 3, 1), np.asarray(labels, dtype=np.int64)

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        return len(self.images)


class Cifar100(Cifar10):
    NUM_CLASSES = 100
