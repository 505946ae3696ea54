"""Conv-layer shapes of the paper's benchmark networks (a copy of
``repro.perfmodel.networks``, pure Python).

(name, C_in, C_out, kernel, stride, H_in, W_in, depthwise)
Only convolutional layers — the paper evaluates conv layers only (§5).
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class ConvLayer:
    name: str
    c_in: int
    c_out: int
    k: int
    stride: int
    h: int
    w: int
    depthwise: bool = False

    @property
    def out_h(self) -> int:
        return self.h // self.stride

    @property
    def out_w(self) -> int:
        return self.w // self.stride

    @property
    def macs(self) -> int:
        ch = self.c_in if not self.depthwise else 1
        return self.out_h * self.out_w * self.k * self.k * ch * self.c_out

    @property
    def weight_count(self) -> int:
        ch = self.c_in if not self.depthwise else 1
        return self.k * self.k * ch * self.c_out

    @property
    def act_in_count(self) -> int:
        return self.h * self.w * self.c_in

    @property
    def act_out_count(self) -> int:
        return self.out_h * self.out_w * self.c_out


def _resnet18() -> List[ConvLayer]:
    ls = [ConvLayer("conv1", 3, 64, 7, 2, 224, 224)]
    cfg = [(64, 64, 56, 2), (64, 128, 56, 2), (128, 256, 28, 2),
           (256, 512, 14, 2)]
    h = 56
    cin = 64
    for i, (ci, co, hh, nblocks) in enumerate(cfg):
        for b in range(nblocks):
            stride = 2 if (b == 0 and i > 0) else 1
            hin = hh if b == 0 else hh // (2 if i > 0 else 1)
            ls.append(ConvLayer(f"l{i}b{b}c1", cin, co, 3, stride, hin, hin))
            ls.append(ConvLayer(f"l{i}b{b}c2", co, co, 3, 1, hin // stride,
                                hin // stride))
            cin = co
    return ls


def _mobilenet_v2() -> List[ConvLayer]:
    # (t expand, c_out, n blocks, stride), input 224
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    ls = [ConvLayer("conv1", 3, 32, 3, 2, 224, 224)]
    cin, h = 32, 112
    for i, (t, c, n, s) in enumerate(cfg):
        for b in range(n):
            stride = s if b == 0 else 1
            hid = cin * t
            if t != 1:
                ls.append(ConvLayer(f"b{i}_{b}_pw1", cin, hid, 1, 1, h, h))
            ls.append(ConvLayer(f"b{i}_{b}_dw", hid, hid, 3, stride, h, h,
                                depthwise=True))
            h = h // stride
            ls.append(ConvLayer(f"b{i}_{b}_pw2", hid, c, 1, 1, h, h))
            cin = c
    ls.append(ConvLayer("conv_last", 320, 1280, 1, 1, 7, 7))
    return ls


def _vgg16_cifar() -> List[ConvLayer]:
    cfg = [(3, 64), (64, 64), (64, 128), (128, 128), (128, 256), (256, 256),
           (256, 256), (256, 512), (512, 512), (512, 512), (512, 512),
           (512, 512), (512, 512)]
    hs = [32, 32, 16, 16, 8, 8, 8, 4, 4, 4, 2, 2, 2]
    return [ConvLayer(f"conv{i}", ci, co, 3, 1, h, h)
            for i, ((ci, co), h) in enumerate(zip(cfg, hs))]


NETWORKS = {
    "resnet18": _resnet18(),
    "mobilenet_v2": _mobilenet_v2(),
    "vgg16_cifar": _vgg16_cifar(),
}
