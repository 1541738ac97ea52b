"""Transform classes. The port's own copy of
``paddle_tpu/vision/transforms/transforms.py``, on numpy HWC images.

The random transforms draw from an explicit generator, ``rng=``: a
``random.Random`` (``RandomResizedCrop``, ``RandomCrop``, the flips, the
colour transforms, ``ColorJitter``, ``RandomRotation``) or a
``numpy.random.RandomState`` (``GaussianNoise``, ``RandomErasing``); by
default one seeded 0, made with the transform. The reference draws the
same values in the same order from the global ``random`` / ``np.random``
streams, so a port transform given ``random.Random(s)`` matches the
reference's after ``random.seed(s)``.
"""
import numbers
import random

import numpy as np

from . import functional as Fv

__all__ = ['Compose', 'BaseTransform', 'ToTensor', 'Resize',
           'RandomResizedCrop', 'CenterCrop', 'RandomHorizontalFlip',
           'RandomVerticalFlip', 'Transpose', 'Normalize',
           'BrightnessTransform', 'SaturationTransform', 'ContrastTransform',
           'HueTransform', 'ColorJitter', 'RandomCrop', 'Pad',
           'RandomRotation', 'Grayscale', 'Permute', 'RandomRotate',
           'BatchCompose', 'CenterCropResize', 'GaussianNoise',
           'RandomErasing']


def _py_rng(rng):
    return rng if rng is not None else random.Random(0)


def _np_rng(rng):
    return rng if rng is not None else np.random.RandomState(0)


class Compose:
    def __init__(self, transforms):
        self.transforms = transforms

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


class BaseTransform:
    def __init__(self, keys=None):
        self.keys = keys

    def __call__(self, inputs):
        return self._apply_image(inputs)

    def _apply_image(self, img):
        raise NotImplementedError


class ToTensor(BaseTransform):
    def __init__(self, data_format='CHW', keys=None):
        super().__init__(keys)
        self.data_format = data_format

    def _apply_image(self, img):
        return Fv.to_tensor(img, self.data_format)


class Resize(BaseTransform):
    def __init__(self, size, interpolation='bilinear', keys=None):
        super().__init__(keys)
        self.size = size
        self.interpolation = interpolation

    def _apply_image(self, img):
        return Fv.resize(img, self.size, self.interpolation)


class RandomResizedCrop(BaseTransform):
    def __init__(self, size, scale=(0.08, 1.0), ratio=(3. / 4, 4. / 3),
                 interpolation='bilinear', keys=None, rng=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.scale = scale
        self.ratio = ratio
        self.rng = _py_rng(rng)

    def _apply_image(self, img):
        img = np.asarray(img)
        h, w = img.shape[:2]
        area = h * w
        for _ in range(10):
            target_area = self.rng.uniform(*self.scale) * area
            aspect = np.exp(self.rng.uniform(np.log(self.ratio[0]),
                                             np.log(self.ratio[1])))
            cw = int(round(np.sqrt(target_area * aspect)))
            ch = int(round(np.sqrt(target_area / aspect)))
            if cw <= w and ch <= h:
                i = self.rng.randint(0, h - ch)
                j = self.rng.randint(0, w - cw)
                return Fv.resize(Fv.crop(img, i, j, ch, cw), self.size)
        return Fv.resize(Fv.center_crop(img, min(h, w)), self.size)


class CenterCrop(BaseTransform):
    def __init__(self, size, keys=None):
        super().__init__(keys)
        self.size = size

    def _apply_image(self, img):
        return Fv.center_crop(img, self.size)


class RandomCrop(BaseTransform):
    def __init__(self, size, padding=None, pad_if_needed=False, fill=0,
                 padding_mode='constant', keys=None, rng=None):
        super().__init__(keys)
        self.size = (size, size) if isinstance(size, numbers.Number) else \
            tuple(size)
        self.padding = padding
        self.pad_if_needed = pad_if_needed
        self.fill = fill
        self.padding_mode = padding_mode
        self.rng = _py_rng(rng)

    def _apply_image(self, img):
        img = np.asarray(img)
        if self.padding is not None:
            img = Fv.pad(img, self.padding, self.fill, self.padding_mode)
        h, w = img.shape[:2]
        th, tw = self.size
        if self.pad_if_needed and (h < th or w < tw):
            img = Fv.pad(img, (max(tw - w, 0), max(th - h, 0)), self.fill,
                         self.padding_mode)
            h, w = img.shape[:2]
        i = self.rng.randint(0, h - th)
        j = self.rng.randint(0, w - tw)
        return Fv.crop(img, i, j, th, tw)


class RandomHorizontalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, rng=None):
        super().__init__(keys)
        self.prob = prob
        self.rng = _py_rng(rng)

    def _apply_image(self, img):
        if self.rng.random() < self.prob:
            return Fv.hflip(img)
        return np.asarray(img)


class RandomVerticalFlip(BaseTransform):
    def __init__(self, prob=0.5, keys=None, rng=None):
        super().__init__(keys)
        self.prob = prob
        self.rng = _py_rng(rng)

    def _apply_image(self, img):
        if self.rng.random() < self.prob:
            return Fv.vflip(img)
        return np.asarray(img)


class Transpose(BaseTransform):
    def __init__(self, order=(2, 0, 1), keys=None):
        super().__init__(keys)
        self.order = order

    def _apply_image(self, img):
        img = np.asarray(img)
        if img.ndim == 2:
            img = img[..., None]
        return img.transpose(self.order)


class Normalize(BaseTransform):
    def __init__(self, mean=0.0, std=1.0, data_format='CHW', to_rgb=False,
                 keys=None):
        super().__init__(keys)
        if isinstance(mean, numbers.Number):
            mean = [mean] * 3
        if isinstance(std, numbers.Number):
            std = [std] * 3
        self.mean = mean
        self.std = std
        self.data_format = data_format

    def _apply_image(self, img):
        return Fv.normalize(img, self.mean, self.std, self.data_format)


class _Jitter(BaseTransform):
    """A colour adjustment by a factor drawn from U(max(0, 1 - value), 1 +
    value) (the hue's from U(-value, value)); value 0 does nothing."""
    _adjust = None

    def __init__(self, value, keys=None, rng=None):
        super().__init__(keys)
        self.value = float(value)
        self.rng = _py_rng(rng)

    def _factor(self):
        return self.rng.uniform(max(0, 1 - self.value), 1 + self.value)

    def _apply_image(self, img):
        if self.value == 0:
            return np.asarray(img)
        return type(self)._adjust(img, self._factor())


class BrightnessTransform(_Jitter):
    _adjust = staticmethod(Fv.adjust_brightness)


class ContrastTransform(_Jitter):
    _adjust = staticmethod(Fv.adjust_contrast)


class SaturationTransform(_Jitter):
    _adjust = staticmethod(Fv.adjust_saturation)


class HueTransform(_Jitter):
    _adjust = staticmethod(Fv.adjust_hue)

    def _factor(self):
        return self.rng.uniform(-self.value, self.value)


class ColorJitter(BaseTransform):
    """The four adjustments in an order shuffled each call; all draw from
    ``rng``."""

    def __init__(self, brightness=0, contrast=0, saturation=0, hue=0,
                 keys=None, rng=None):
        super().__init__(keys)
        self.rng = _py_rng(rng)
        self.transforms = [BrightnessTransform(brightness, rng=self.rng),
                           ContrastTransform(contrast, rng=self.rng),
                           SaturationTransform(saturation, rng=self.rng),
                           HueTransform(hue, rng=self.rng)]

    def _apply_image(self, img):
        order = list(range(4))
        self.rng.shuffle(order)
        for i in order:
            img = self.transforms[i](img)
        return img


class Pad(BaseTransform):
    def __init__(self, padding, fill=0, padding_mode='constant', keys=None):
        super().__init__(keys)
        self.padding = padding
        self.fill = fill
        self.padding_mode = padding_mode

    def _apply_image(self, img):
        return Fv.pad(img, self.padding, self.fill, self.padding_mode)


class RandomRotation(BaseTransform):
    def __init__(self, degrees, interpolation='nearest', expand=False,
                 center=None, fill=0, keys=None, rng=None):
        super().__init__(keys)
        if isinstance(degrees, numbers.Number):
            degrees = (-degrees, degrees)
        self.degrees = degrees
        self.expand = expand
        self.center = center
        self.fill = fill
        self.rng = _py_rng(rng)

    def _apply_image(self, img):
        angle = self.rng.uniform(*self.degrees)
        return Fv.rotate(img, angle, expand=self.expand, center=self.center,
                         fill=self.fill)


class Grayscale(BaseTransform):
    def __init__(self, num_output_channels=1, keys=None):
        super().__init__(keys)
        self.num_output_channels = num_output_channels

    def _apply_image(self, img):
        return Fv.to_grayscale(img, self.num_output_channels)


Permute = Transpose
RandomRotate = RandomRotation


class BatchCompose:
    """Each transform applied to every sample of a batch in turn."""

    def __init__(self, transforms=()):
        self.transforms = list(transforms)

    def __call__(self, data):
        for f in self.transforms:
            data = [f(d) for d in data]
        return data


class CenterCropResize(BaseTransform):
    """The centred square of side ``size / (size + crop_padding)`` of the
    shorter side, resized to ``size``."""

    def __init__(self, size, crop_padding=32, interpolation='bilinear'):
        super().__init__()
        self.size = (size, size) if isinstance(size, int) else size
        self.crop_padding = crop_padding
        self.interpolation = interpolation

    def _apply_image(self, img):
        arr = Fv._as_np(img)
        h, w = arr.shape[:2]
        c = min(self.size)
        side = int(c / (c + self.crop_padding) * min(h, w))
        top = (h - side) // 2
        left = (w - side) // 2
        return Fv.resize(arr[top:top + side, left:left + side], self.size,
                         self.interpolation)


class GaussianNoise(BaseTransform):
    """Additive N(mean, variance) pixel noise from ``rng`` (a numpy
    ``RandomState``), as float32."""

    def __init__(self, mean=0.0, variance=1.0, rng=None):
        super().__init__()
        self.mean = mean
        self.std = variance ** 0.5
        self.rng = _np_rng(rng)

    def _apply_image(self, img):
        arr = Fv._as_np(img).astype('float32')
        noise = self.rng.normal(self.mean, self.std, arr.shape)
        return (arr + noise).astype('float32')


class RandomErasing(BaseTransform):
    """With probability ``prob``, a rectangle of ``scale`` of the area and
    ``ratio`` aspect set to ``value``; draws from ``rng`` (a numpy
    ``RandomState``)."""

    def __init__(self, prob=0.5, scale=(0.02, 0.33), ratio=(0.3, 3.3),
                 value=0, inplace=False, rng=None):
        super().__init__()
        self.prob = prob
        self.scale = scale
        self.ratio = ratio
        self.value = value
        self.rng = _np_rng(rng)

    def _apply_image(self, img):
        arr = Fv._as_np(img).copy()
        if self.rng.rand() > self.prob:
            return arr
        h, w = arr.shape[:2]
        area = h * w
        for _ in range(10):
            target = area * self.rng.uniform(*self.scale)
            aspect = self.rng.uniform(*self.ratio)
            eh = int(round((target * aspect) ** 0.5))
            ew = int(round((target / aspect) ** 0.5))
            if eh < h and ew < w:
                top = self.rng.randint(0, h - eh)
                left = self.rng.randint(0, w - ew)
                arr[top:top + eh, left:left + ew] = self.value
                break
        return arr
