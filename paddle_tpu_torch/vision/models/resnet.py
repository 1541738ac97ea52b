"""The ResNet family. Counterpart of ``paddle_tpu/vision/models/resnet.py``
(``ResNet``, ``BasicBlock``, ``BottleneckBlock``, ``resnet18/34/50/101/
152``).

The layers' names are the reference's (``conv1``, ``bn1``,
``layer1.0.downsample.0``, ``fc``, ...) and ``fc`` is the port's own
``Linear``, so ``interop.load_paddle_tpu_state`` moves a model's state
key for key (``fc.weight`` transposed). ``data_format='NHWC'`` runs
channels-last end to end: every convolution, BatchNorm and pool takes
the N H W C tensor (cuDNN reads its channels-first view as a
channels-last tensor, without a copy). ``space_to_depth_stem=True``
(NHWC only) computes the 7x7/2 stem as the reference's exactly
equivalent 4x4/1 convolution of the 2x2 space-to-depth packed input; the
parameter stays the [64, 3, 7, 7] weight. Layers are built on
``device`` (the CUDA device unless ``device='cpu'``) and draw their
weights from ``generator``.
"""
import functools

import torch

from ... import nn
from ...device import resolve_device
from ...nn import functional as F

__all__ = ['ResNet', 'BasicBlock', 'BottleneckBlock', 'resnet18',
           'resnet34', 'resnet50', 'resnet101', 'resnet152']


class BasicBlock(torch.nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format='NCHW', *, device=None, generator=None):
        super().__init__()
        df = data_format
        kw = dict(device=device, generator=generator)
        # data_format binds only into the default norm: a caller's
        # norm_layer keeps its own signature
        norm_layer = norm_layer or functools.partial(nn.BatchNorm2D,
                                                     data_format=df, **kw)
        self.conv1 = nn.Conv2D(inplanes, planes, 3, padding=1, stride=stride,
                               bias_attr=False, data_format=df, **kw)
        self.bn1 = norm_layer(planes)
        self.relu = nn.ReLU()
        self.conv2 = nn.Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                               data_format=df, **kw)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class BottleneckBlock(torch.nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format='NCHW', *, device=None, generator=None):
        super().__init__()
        df = data_format
        kw = dict(device=device, generator=generator)
        norm_layer = norm_layer or functools.partial(nn.BatchNorm2D,
                                                     data_format=df, **kw)
        width = int(planes * (base_width / 64.)) * groups
        self.conv1 = nn.Conv2D(inplanes, width, 1, bias_attr=False,
                               data_format=df, **kw)
        self.bn1 = norm_layer(width)
        self.conv2 = nn.Conv2D(width, width, 3, padding=dilation,
                               stride=stride, groups=groups,
                               dilation=dilation, bias_attr=False,
                               data_format=df, **kw)
        self.bn2 = norm_layer(width)
        self.conv3 = nn.Conv2D(width, planes * self.expansion, 1,
                               bias_attr=False, data_format=df, **kw)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return self.relu(out + identity)


class ResNet(torch.nn.Module):
    def __init__(self, block, depth, num_classes=1000, with_pool=True,
                 data_format='NCHW', space_to_depth_stem=False, *,
                 device=None, generator=None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        device = resolve_device(device)
        kw = self._kw = dict(device=device, generator=generator)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.data_format = data_format
        if space_to_depth_stem and data_format != 'NHWC':
            raise ValueError("space_to_depth_stem requires data_format="
                             "'NHWC'")
        self.space_to_depth_stem = space_to_depth_stem
        self._norm_layer = functools.partial(nn.BatchNorm2D,
                                             data_format=data_format, **kw)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = nn.Conv2D(3, self.inplanes, kernel_size=7, stride=2,
                               padding=3, bias_attr=False,
                               data_format=data_format, **kw)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(kernel_size=3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes, **kw)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        norm_layer = self._norm_layer
        downsample = None
        df = self.data_format
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False, data_format=df,
                          **self._kw),
                norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample, 1, 64,
                        self.dilation, norm_layer, data_format=df,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, norm_layer=norm_layer,
                                data_format=df, **self._kw))
        return nn.Sequential(*layers)

    def _stem_s2d(self, x):
        """The 7x7/2 stem as a 4x4/1 convolution of the 2x2-packed input,
        an exact rewrite: packed row p holds rows {2p, 2p + 1}, so output
        row i reads p in {i - 2, ..., i + 1} (kernel 4, pads (2, 1)), and
        the 7x7 weight, zero-padded in front to 8x8, is regrouped by the
        same (ry, rx, c) packing."""
        B, H, W, C = x.shape
        if H % 2 or W % 2:
            raise ValueError(
                f"space_to_depth_stem needs even input H and W (got "
                f"{H}x{W}); pad the input or disable the packed stem")
        x2 = x.reshape(B, H // 2, 2, W // 2, 2, C).permute(0, 1, 3, 2, 4, 5) \
            .reshape(B, H // 2, W // 2, 4 * C)
        x2 = F.pad(x2, [2, 1, 2, 1], data_format='NHWC')
        w = self.conv1.weight.permute(2, 3, 1, 0)          # [7, 7, C, O]
        w = F.pad(w, [1, 0, 1, 0, 0, 0, 0, 0])              # [8, 8, C, O]
        O = w.shape[-1]
        w2 = w.reshape(4, 2, 4, 2, C, O).permute(0, 2, 1, 3, 4, 5) \
            .reshape(4, 4, 4 * C, O).permute(3, 2, 0, 1)    # [O, 4C, 4, 4]
        return F.conv2d(x2, w2, stride=1, padding=0, data_format='NHWC')

    def forward(self, x):
        if self.space_to_depth_stem:
            x = self.relu(self.bn1(self._stem_s2d(x)))
        else:
            x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = x.flatten(1)
            x = self.fc(x)
        return x


def _resnet(Block, depth, pretrained, **kwargs):
    if pretrained:
        raise RuntimeError("pretrained weights unavailable offline; "
                           "load a state dict with model.load_state_dict")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet(BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet(BottleneckBlock, 152, pretrained, **kwargs)
