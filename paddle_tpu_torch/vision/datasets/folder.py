"""DatasetFolder / ImageFolder. The port's copy of
``paddle_tpu/vision/datasets/folder.py``."""
import os

import numpy as np

from ...io import Dataset

__all__ = ['DatasetFolder', 'ImageFolder']

IMG_EXTENSIONS = ('.jpg', '.jpeg', '.png', '.ppm', '.bmp', '.npy')


def _default_loader(path):
    if path.endswith('.npy'):
        return np.load(path)
    try:
        from PIL import Image
        with Image.open(path) as img:
            return np.asarray(img.convert('RGB'))
    except ImportError:
        raise RuntimeError("PIL unavailable; use .npy images")


class DatasetFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        classes = sorted(d for d in os.listdir(root)
                         if os.path.isdir(os.path.join(root, d)))
        self.classes = classes
        self.class_to_idx = {c: i for i, c in enumerate(classes)}
        self.samples = []
        for c in classes:
            d = os.path.join(root, c)
            for dirpath, _, filenames in sorted(os.walk(d)):
                for fn in sorted(filenames):
                    path = os.path.join(dirpath, fn)
                    ok = is_valid_file(path) if is_valid_file else \
                        fn.lower().endswith(extensions)
                    if ok:
                        self.samples.append((path, self.class_to_idx[c]))

    def __getitem__(self, index):
        path, target = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return sample, target

    def __len__(self):
        return len(self.samples)


class ImageFolder(Dataset):
    def __init__(self, root, loader=None, extensions=None, transform=None,
                 is_valid_file=None):
        self.root = root
        self.transform = transform
        self.loader = loader or _default_loader
        extensions = extensions or IMG_EXTENSIONS
        self.samples = []
        for dirpath, _, filenames in sorted(os.walk(root)):
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                ok = is_valid_file(path) if is_valid_file else \
                    fn.lower().endswith(extensions)
                if ok:
                    self.samples.append(path)

    def __getitem__(self, index):
        path = self.samples[index]
        sample = self.loader(path)
        if self.transform is not None:
            sample = self.transform(sample)
        return [sample]

    def __len__(self):
        return len(self.samples)
