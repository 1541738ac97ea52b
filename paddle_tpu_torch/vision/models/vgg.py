"""VGG. Counterpart of ``paddle_tpu/vision/models/vgg.py``. The
classifier's two ``Dropout``s draw from ``dropout_state`` (a
``kernels.philox.DropoutState``; without one a training forward raises, as
every dropout of the port does)."""
import torch

from ... import nn
from ...device import resolve_device

__all__ = ['VGG', 'vgg11', 'vgg13', 'vgg16', 'vgg19']

cfgs = {
    'A': [64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512, 'M'],
    'B': [64, 64, 'M', 128, 128, 'M', 256, 256, 'M', 512, 512, 'M', 512, 512,
          'M'],
    'D': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 'M', 512, 512, 512, 'M',
          512, 512, 512, 'M'],
    'E': [64, 64, 'M', 128, 128, 'M', 256, 256, 256, 256, 'M', 512, 512, 512,
          512, 'M', 512, 512, 512, 512, 'M'],
}


def make_layers(cfg, batch_norm=False, *, device=None, generator=None):
    kw = dict(device=device, generator=generator)
    layers = []
    in_channels = 3
    for v in cfg:
        if v == 'M':
            layers.append(nn.MaxPool2D(kernel_size=2, stride=2))
        else:
            conv2d = nn.Conv2D(in_channels, v, kernel_size=3, padding=1, **kw)
            layers += [conv2d, nn.BatchNorm2D(v, **kw), nn.ReLU()] \
                if batch_norm else [conv2d, nn.ReLU()]
            in_channels = v
    return nn.Sequential(*layers)


class VGG(torch.nn.Module):
    def __init__(self, features, num_classes=1000, with_pool=True, *,
                 device=None, generator=None, dropout_state=None):
        super().__init__()
        kw = dict(device=resolve_device(device), generator=generator)
        self.features = features
        self.num_classes = num_classes
        self.with_pool = with_pool
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((7, 7))
        if num_classes > 0:
            self.classifier = nn.Sequential(
                nn.Linear(512 * 7 * 7, 4096, **kw), nn.ReLU(),
                nn.Dropout(dropout_state=dropout_state),
                nn.Linear(4096, 4096, **kw), nn.ReLU(),
                nn.Dropout(dropout_state=dropout_state),
                nn.Linear(4096, num_classes, **kw))

    def forward(self, x):
        x = self.features(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.classifier(x.flatten(1))
        return x


def _vgg(cfg, batch_norm, pretrained, device=None, generator=None,
         **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable offline")
    device = resolve_device(device)
    return VGG(make_layers(cfgs[cfg], batch_norm, device=device,
                           generator=generator),
               device=device, generator=generator, **kwargs)


def vgg11(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('A', batch_norm, pretrained, **kwargs)


def vgg13(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('B', batch_norm, pretrained, **kwargs)


def vgg16(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('D', batch_norm, pretrained, **kwargs)


def vgg19(pretrained=False, batch_norm=False, **kwargs):
    return _vgg('E', batch_norm, pretrained, **kwargs)
