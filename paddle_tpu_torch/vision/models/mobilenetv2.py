"""MobileNetV2. Counterpart of ``paddle_tpu/vision/models/mobilenetv2.py``
(inverted residuals, ``ReLU6``). The classifier's ``Dropout(0.2)`` draws
from ``dropout_state`` (without one a training forward raises)."""
import torch

from ... import nn
from ...device import resolve_device

__all__ = ['MobileNetV2', 'mobilenet_v2']


def _make_divisible(v, divisor=8, min_value=None):
    if min_value is None:
        min_value = divisor
    new_v = max(min_value, int(v + divisor / 2) // divisor * divisor)
    if new_v < 0.9 * v:
        new_v += divisor
    return new_v


class ConvBNReLU(torch.nn.Sequential):
    def __init__(self, in_planes, out_planes, kernel_size=3, stride=1,
                 groups=1, **kw):
        padding = (kernel_size - 1) // 2
        super().__init__(
            nn.Conv2D(in_planes, out_planes, kernel_size, stride, padding,
                      groups=groups, bias_attr=False, **kw),
            nn.BatchNorm2D(out_planes, **kw),
            nn.ReLU6())


class InvertedResidual(torch.nn.Module):
    def __init__(self, inp, oup, stride, expand_ratio, **kw):
        super().__init__()
        self.stride = stride
        hidden_dim = int(round(inp * expand_ratio))
        self.use_res_connect = self.stride == 1 and inp == oup
        layers = []
        if expand_ratio != 1:
            layers.append(ConvBNReLU(inp, hidden_dim, kernel_size=1, **kw))
        layers.extend([
            ConvBNReLU(hidden_dim, hidden_dim, stride=stride,
                       groups=hidden_dim, **kw),
            nn.Conv2D(hidden_dim, oup, 1, 1, 0, bias_attr=False, **kw),
            nn.BatchNorm2D(oup, **kw)])
        self.conv = nn.Sequential(*layers)

    def forward(self, x):
        if self.use_res_connect:
            return x + self.conv(x)
        return self.conv(x)


class MobileNetV2(torch.nn.Module):
    def __init__(self, scale=1.0, num_classes=1000, with_pool=True, *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        settings = [[1, 16, 1, 1], [6, 24, 2, 2], [6, 32, 3, 2],
                    [6, 64, 4, 2], [6, 96, 3, 1], [6, 160, 3, 2],
                    [6, 320, 1, 1]]
        input_channel = _make_divisible(32 * scale)
        self.last_channel = _make_divisible(1280 * max(1.0, scale))
        features = [ConvBNReLU(3, input_channel, stride=2, **kw)]
        for t, c, n, s in settings:
            output_channel = _make_divisible(c * scale)
            for i in range(n):
                features.append(InvertedResidual(
                    input_channel, output_channel, s if i == 0 else 1,
                    expand_ratio=t, **kw))
                input_channel = output_channel
        features.append(ConvBNReLU(input_channel, self.last_channel,
                                   kernel_size=1, **kw))
        self.features = nn.Sequential(*features)
        if with_pool:
            self.pool2d_avg = nn.AdaptiveAvgPool2D(1)
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Dropout(0.2, dropout_state=dropout_state),
                nn.Linear(self.last_channel, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.pool2d_avg(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def mobilenet_v2(pretrained=False, scale=1.0, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable offline")
    return MobileNetV2(scale=scale, **kwargs)
