"""Im2Col GEMM traces for the paper's four benchmark CNNs (Sec. IV-B).

The port's own copy of ``repro/core/workloads.py`` (pure Python).

Each convolution layer (Cin, Cout, k, stride, groups) at spatial size HxW
is unrolled into a GEMM per the Im2Col transform the paper cites [7]:

    output (M x N) = Toeplitz weights (M x K) @ input patches (K x N)
    M = Cout / groups,  K = (Cin / groups) * k * k,  N = Hout * Wout

repeated ``groups`` times (depthwise convs: groups == Cin, K == k*k).
Fully-connected layers are GEMMs with N == 1 (batch folded at sim level).

Architectures are the standard published ImageNet (224x224) definitions:
MobileNet-V2 [Sandler+18], ShuffleNet-V2 1x [Ma+18], ResNet-50 [He+16],
GoogLeNet/Inception-v1 [Szegedy+15].
"""

from __future__ import annotations

import dataclasses

__all__ = ["GemmShape", "cnn_gemm_trace", "CNNS", "total_macs"]


@dataclasses.dataclass(frozen=True)
class GemmShape:
    """One Im2Col GEMM: (M x K) @ (K x N), executed ``groups * repeat`` times."""

    name: str
    m: int
    k: int
    n: int
    groups: int = 1
    repeat: int = 1

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n * self.groups * self.repeat

    @property
    def dots(self) -> int:
        """Dot products of length K per instance."""
        return self.m * self.n


class _Net:
    """Tiny builder: tracks spatial size, emits GemmShapes."""

    def __init__(self, name: str, hw: int = 224):
        self.name, self.hw, self.c = name, hw, 3
        self.layers: list[GemmShape] = []

    def conv(self, cout: int, k: int, stride: int = 1, groups: int = 1,
             cin: int | None = None, tag: str = ""):
        cin = self.c if cin is None else cin
        if stride > 1:
            self.hw = (self.hw + stride - 1) // stride
        n = self.hw * self.hw
        self.layers.append(GemmShape(
            tag or f"conv{len(self.layers)}", m=cout // groups,
            k=(cin // groups) * k * k, n=n, groups=groups))
        self.c = cout
        return self

    def dw(self, k: int = 3, stride: int = 1):          # depthwise
        return self.conv(self.c, k, stride, groups=self.c, tag=f"dw{len(self.layers)}")

    def pool(self, stride: int = 2):
        self.hw = (self.hw + stride - 1) // stride
        return self

    def fc(self, cout: int):
        self.layers.append(GemmShape(f"fc{len(self.layers)}", m=cout, k=self.c, n=1))
        self.c = cout
        return self


def _resnet50() -> list[GemmShape]:
    net = _Net("resnet50")
    net.conv(64, 7, 2).pool(2)
    for cmid, cout, blocks, stride in ((64, 256, 3, 1), (128, 512, 4, 2),
                                       (256, 1024, 6, 2), (512, 2048, 3, 2)):
        cin = net.c
        net.conv(cout, 1, stride, cin=cin, tag="proj")       # downsample proj
        hw_after = net.hw
        net.hw, net.c = hw_after * stride, cin               # rewind for main path
        net.conv(cmid, 1, 1)
        net.conv(cmid, 3, stride)
        net.conv(cout, 1, 1)
        for _ in range(blocks - 1):
            net.conv(cmid, 1, 1)
            net.conv(cmid, 3, 1)
            net.conv(cout, 1, 1)
    net.pool(net.hw).fc(1000)
    return net.layers


def _mobilenet_v2() -> list[GemmShape]:
    net = _Net("mobilenet_v2")
    net.conv(32, 3, 2)
    cfg = ((1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1))
    for t, c, n, s in cfg:
        for i in range(n):
            cin = net.c
            if t != 1:
                net.conv(cin * t, 1, 1)
            net.dw(3, s if i == 0 else 1)
            net.conv(c, 1, 1)
    net.conv(1280, 1, 1)
    net.pool(net.hw).fc(1000)
    return net.layers


def _shufflenet_v2() -> list[GemmShape]:
    net = _Net("shufflenet_v2")
    net.conv(24, 3, 2).pool(2)
    for cout, units in ((116, 4), (232, 8), (464, 4)):
        half = cout // 2
        cin = net.c
        # downsample unit: both branches (stride-2 dw + 1x1 each)
        net.dw(3, 2)
        net.conv(half, 1, 1, cin=cin, tag="branch_proj")
        net.c = cin
        net.conv(half, 1, 1, cin=cin)
        net.dw(3, 1)
        net.conv(half, 1, 1, cin=half)
        net.c = cout
        for _ in range(units - 1):  # basic units act on half the channels
            net.conv(half, 1, 1, cin=half)
            saved = net.c
            net.c = half
            net.dw(3, 1)
            net.conv(half, 1, 1, cin=half)
            net.c = saved
    net.conv(1024, 1, 1)
    net.pool(net.hw).fc(1000)
    return net.layers


_INCEPTION = (  # (n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_proj)
    ("3a", 64, 96, 128, 16, 32, 32), ("3b", 128, 128, 192, 32, 96, 64),
    ("4a", 192, 96, 208, 16, 48, 64), ("4b", 160, 112, 224, 24, 64, 64),
    ("4c", 128, 128, 256, 24, 64, 64), ("4d", 112, 144, 288, 32, 64, 64),
    ("4e", 256, 160, 320, 32, 128, 128), ("5a", 256, 160, 320, 32, 128, 128),
    ("5b", 384, 192, 384, 48, 128, 128),
)


def _googlenet() -> list[GemmShape]:
    net = _Net("googlenet")
    net.conv(64, 7, 2).pool(2)
    net.conv(64, 1, 1)
    net.conv(192, 3, 1)
    net.pool(2)
    for name, n1, n3r, n3, n5r, n5, pp in _INCEPTION:
        if name in ("4a", "5a"):
            net.pool(2)
        cin, hw = net.c, net.hw
        n = hw * hw
        L = net.layers
        L.append(GemmShape(f"i{name}_1x1", n1, cin, n))
        L.append(GemmShape(f"i{name}_3x3r", n3r, cin, n))
        L.append(GemmShape(f"i{name}_3x3", n3, n3r * 9, n))
        L.append(GemmShape(f"i{name}_5x5r", n5r, cin, n))
        L.append(GemmShape(f"i{name}_5x5", n5, n5r * 25, n))
        L.append(GemmShape(f"i{name}_pool", pp, cin, n))
        net.c = n1 + n3 + n5 + pp
    net.pool(net.hw).fc(1000)
    return net.layers


CNNS = {
    "mobilenet_v2": _mobilenet_v2,
    "shufflenet_v2": _shufflenet_v2,
    "resnet50": _resnet50,
    "googlenet": _googlenet,
}


def cnn_gemm_trace(name: str) -> list[GemmShape]:
    return CNNS[name]()


def total_macs(name: str) -> int:
    return sum(g.macs for g in cnn_gemm_trace(name))
