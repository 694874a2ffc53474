"""ResNet (counterpart of `paddle_tpu/vision/models/resnet.py`): the
JAX package's blocks, constructors and state-dict names, so a JAX
ResNet's parameters and BatchNorm buffers load by name
(`models.state_dict_from_numpy`). `data_format="NHWC"` runs the whole
stack channel-last: on the card each NHWC activation is a channels_last
tensor, which cuDNN convolves without a transpose. Weights are
layout-independent ([O, I/groups, kH, kW] either way).

The port's own initial weights are drawn at construction, in
construction order, from one `torch.Generator` seeded with `seed` on the
parameters' device, by the JAX layers' initializers (conv
U(+-1/sqrt(fan_in)), BatchNorm 1/0, Linear XavierUniform with a bias 0).
`stem_s2d=True` (the JAX package's space-to-depth form of the 7x7/s2
stem, an exact rewrite for the TPU) computes the same function here with
the plain convolution, on the same domain: NHWC with even H and W.
"""
import functools

import torch
from torch import nn as tnn

from ... import nn
from ...device import get_device
from ...nn.layout import resolve_data_format
from ...tensor import flatten

__all__ = ["ResNet", "resnet18", "resnet34", "resnet50", "resnet101",
           "resnet152", "wide_resnet50_2", "wide_resnet101_2",
           "resnext50_32x4d", "resnext50_64x4d", "resnext101_32x4d",
           "resnext101_64x4d", "resnext152_32x4d", "resnext152_64x4d"]


def _norm(norm_layer, data_format, device):
    """The blocks' norm constructor: BatchNorm2D on `device` by default; a
    caller's `norm_layer` keeps the JAX contract (given data_format only
    when it is not NCHW)."""
    if norm_layer is None:
        return functools.partial(nn.BatchNorm2D, data_format=data_format,
                                 device=device)
    if data_format != "NCHW":
        return lambda c: norm_layer(c, data_format=data_format)
    return norm_layer


def _add_relu(relu, out, identity):
    """relu(out + identity), in a named range so a profile can price the
    residual's eager add and ReLU."""
    with torch.profiler.record_function("residual_add_relu"):
        return relu(out + identity)


class BasicBlock(tnn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__()
        nl = _norm(norm_layer, data_format, device)
        conv = functools.partial(nn.Conv2D, bias_attr=False,
                                 data_format=data_format, device=device,
                                 generator=generator)
        self.conv1 = conv(inplanes, planes, 3, padding=1, stride=stride)
        self.bn1 = nl(planes)
        self.relu = nn.ReLU()
        self.conv2 = conv(planes, planes, 3, padding=1)
        self.bn2 = nl(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return _add_relu(self.relu, out, identity)


class BottleneckBlock(tnn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, groups=1,
                 base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", *, device=None, generator=None):
        super().__init__()
        width = int(planes * (base_width / 64.0)) * groups
        nl = _norm(norm_layer, data_format, device)
        conv = functools.partial(nn.Conv2D, bias_attr=False,
                                 data_format=data_format, device=device,
                                 generator=generator)
        self.conv1 = conv(inplanes, width, 1)
        self.bn1 = nl(width)
        self.conv2 = conv(width, width, 3, padding=dilation, stride=stride,
                          groups=groups, dilation=dilation)
        self.bn2 = nl(width)
        self.conv3 = conv(width, planes * self.expansion, 1)
        self.bn3 = nl(planes * self.expansion)
        self.relu = nn.ReLU()
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = self.relu(self.bn1(self.conv1(x)))
        out = self.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return _add_relu(self.relu, out, identity)


class ResNet(tnn.Module):
    """ResNet of `depth` 18-152 from `block`; `width` is the bottleneck's
    base width, `groups` its grouped 3x3 (ResNeXt); without `with_pool`
    no average pool, with `num_classes <= 0` no fc (the features are
    returned). `device=None` means the card."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format=None, stem_s2d=False,
                 *, device=None, seed=0):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        self.groups = groups
        self.base_width = width
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.inplanes = 64
        self.dilation = 1
        data_format = resolve_data_format(data_format, 2)
        self.data_format = data_format
        self.stem_s2d = bool(stem_s2d)
        if self.stem_s2d and data_format != "NHWC":
            raise ValueError("stem_s2d requires data_format='NHWC'")
        self._device = dev = get_device(device)
        self._generator = torch.Generator(device=dev)
        self._generator.manual_seed(int(seed))
        df = dict(data_format=data_format, device=dev)
        self.conv1 = nn.Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                               bias_attr=False, generator=self._generator,
                               **df)
        self.bn1 = nn.BatchNorm2D(self.inplanes, **df)
        self.relu = nn.ReLU()
        self.maxpool = nn.MaxPool2D(3, stride=2, padding=1,
                                    data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = nn.AdaptiveAvgPool2D((1, 1),
                                                data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=dev, generator=self._generator)

    def _make_layer(self, block, planes, blocks, stride=1, dilate=False):
        downsample = None
        kw = dict(data_format=self.data_format, device=self._device)
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                nn.Conv2D(self.inplanes, planes * block.expansion, 1,
                          stride=stride, bias_attr=False,
                          generator=self._generator, **kw),
                nn.BatchNorm2D(planes * block.expansion, **kw))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width, self.dilation,
                        generator=self._generator, **kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                generator=self._generator, **kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        if self.stem_s2d and (x.shape[1] % 2 or x.shape[2] % 2):
            raise ValueError(f"stem_s2d takes even spatial dims, got "
                             f"{tuple(x.shape)}")
        x = self.relu(self.bn1(self.conv1(x)))
        x = self.maxpool(x)
        x = self.layer1(x)
        x = self.layer2(x)
        x = self.layer3(x)
        x = self.layer4(x)
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = flatten(x, 1)
            x = self.fc(x)
        return x


def _resnet(arch, Block, depth, pretrained, **kwargs):
    if pretrained:
        raise NotImplementedError("no pretrained weight hub: load converted "
                                  "weights with load_state_dict")
    return ResNet(Block, depth, **kwargs)


def resnet18(pretrained=False, **kwargs):
    return _resnet("resnet18", BasicBlock, 18, pretrained, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return _resnet("resnet34", BasicBlock, 34, pretrained, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return _resnet("resnet50", BottleneckBlock, 50, pretrained, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return _resnet("resnet101", BottleneckBlock, 101, pretrained, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return _resnet("resnet152", BottleneckBlock, 152, pretrained, **kwargs)


def resnext50_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext50_32x4d", BottleneckBlock, 50, pretrained,
                   **kwargs)


def resnext50_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext50_64x4d", BottleneckBlock, 50, pretrained,
                   **kwargs)


def resnext101_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext101_32x4d", BottleneckBlock, 101, pretrained,
                   **kwargs)


def resnext101_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext101_64x4d", BottleneckBlock, 101, pretrained,
                   **kwargs)


def resnext152_32x4d(pretrained=False, **kwargs):
    kwargs.update(groups=32, width=4)
    return _resnet("resnext152_32x4d", BottleneckBlock, 152, pretrained,
                   **kwargs)


def resnext152_64x4d(pretrained=False, **kwargs):
    kwargs.update(groups=64, width=4)
    return _resnet("resnext152_64x4d", BottleneckBlock, 152, pretrained,
                   **kwargs)


def wide_resnet50_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet("wide_resnet50_2", BottleneckBlock, 50, pretrained,
                   **kwargs)


def wide_resnet101_2(pretrained=False, **kwargs):
    kwargs["width"] = 128
    return _resnet("wide_resnet101_2", BottleneckBlock, 101, pretrained,
                   **kwargs)
