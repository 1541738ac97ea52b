"""VOC2012 segmentation. The port's copy of
``paddle_tpu/vision/datasets/voc2012.py``.

Synthetic fallback: random images + blob masks."""
import numpy as np

from ...io import Dataset

__all__ = ['VOC2012']


class VOC2012(Dataset):
    def __init__(self, data_file=None, mode='train', transform=None,
                 download=True, backend='cv2'):
        self.transform = transform
        self.synthetic = True
        # distinct seed per mode string (val vs test must differ)
        rng = np.random.RandomState(
            {'train': 4, 'test': 5, 'valid': 8}.get(mode, 9))
        n = 256 if mode == 'train' else 64
        self.images = (rng.rand(n, 128, 128, 3) * 255).astype(np.uint8)
        masks = np.zeros((n, 128, 128), dtype=np.uint8)
        for i in range(n):
            cx, cy = rng.randint(32, 96, 2)
            r = rng.randint(10, 30)
            yy, xx = np.mgrid[0:128, 0:128]
            masks[i][(yy - cy) ** 2 + (xx - cx) ** 2 < r * r] = \
                rng.randint(1, 21)
        self.masks = masks

    def __getitem__(self, idx):
        img, mask = self.images[idx], self.masks[idx]
        if self.transform is not None:
            img = self.transform(img)
        else:
            img = img.astype(np.float32).transpose(2, 0, 1) / 255.0
        return img, mask.astype(np.int64)

    def __len__(self):
        return len(self.images)
