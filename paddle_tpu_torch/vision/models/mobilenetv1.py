"""MobileNetV1. Counterpart of ``paddle_tpu/vision/models/mobilenetv1.py``
(depthwise convolutions: ``groups`` = channels)."""
import torch

from ... import nn
from ...device import resolve_device

__all__ = ['MobileNetV1', 'mobilenet_v1']


class ConvBNLayer(torch.nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride,
                 padding, num_groups=1, **kw):
        super().__init__()
        self._conv = nn.Conv2D(in_channels, out_channels, kernel_size,
                               stride=stride, padding=padding,
                               groups=num_groups, bias_attr=False, **kw)
        self._norm_layer = nn.BatchNorm2D(out_channels, **kw)
        self._act = nn.ReLU()

    def forward(self, x):
        return self._act(self._norm_layer(self._conv(x)))


class DepthwiseSeparable(torch.nn.Module):
    def __init__(self, in_channels, out_channels1, out_channels2, num_groups,
                 stride, scale, **kw):
        super().__init__()
        self._depthwise_conv = ConvBNLayer(
            in_channels, int(out_channels1 * scale), 3, stride, 1,
            num_groups=int(num_groups * scale), **kw)
        self._pointwise_conv = ConvBNLayer(
            int(out_channels1 * scale), int(out_channels2 * scale), 1, 1, 0,
            **kw)

    def forward(self, x):
        return self._pointwise_conv(self._depthwise_conv(x))


class MobileNetV1(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.scale = scale
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.conv1 = ConvBNLayer(3, int(32 * scale), 3, 2, 1, **kw)
        cfg = [
            (32, 32, 64, 32, 1), (64, 64, 128, 64, 2),
            (128, 128, 128, 128, 1), (128, 128, 256, 128, 2),
            (256, 256, 256, 256, 1), (256, 256, 512, 256, 2),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 512, 512, 1),
            (512, 512, 512, 512, 1), (512, 512, 1024, 512, 2),
            (1024, 1024, 1024, 1024, 1),
        ]
        self.blocks = nn.Sequential(*[
            DepthwiseSeparable(int(in_c * scale), c1, c2, g, s, scale, **kw)
            for in_c, c1, c2, g, s in cfg])
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.fc = nn.Linear(int(1024 * scale), num_classes, **kw)

    def forward(self, x):
        x = self.blocks(self.conv1(x))
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.fc(x.flatten(1))
        return x


def mobilenet_v1(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable offline")
    return MobileNetV1(scale=scale, **kwargs)
