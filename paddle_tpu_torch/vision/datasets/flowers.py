"""Flowers dataset. The port's copy of
``paddle_tpu/vision/datasets/flowers.py``.

Always the synthetic set (nothing downloads)."""
import numpy as np

from ...io import Dataset
from .cifar import _synthetic

__all__ = ['Flowers']


class Flowers(Dataset):
    def __init__(self, data_file=None, label_file=None, setid_file=None,
                 mode='train', transform=None, download=True, backend='cv2'):
        self.transform = transform
        self.synthetic = True
        n = 1024 if mode == 'train' else 256
        # distinct seed per mode string: valid and test must not be the
        # same byte-for-byte samples
        seed = {'train': 2, 'test': 3, 'valid': 6}.get(mode, 7)
        imgs, labels = _synthetic(n, 102, seed)
        # upsample to a flower-ish resolution
        self.images = np.repeat(np.repeat(imgs, 7, axis=1), 7, axis=2)
        self.labels = labels

    def __getitem__(self, idx):
        img, label = self.images[idx], self.labels[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, np.asarray(label, dtype=np.int64)

    def __len__(self):
        return len(self.images)
