"""DNN topology descriptions (the GxM "Network List").

``resnet50()`` reproduces the paper's benchmark topology; its 20 distinct
convolution shapes (paper Table I) are exported as ``RESNET50_LAYERS`` and
drive the per-layer benchmarks.  ``inception_v3()`` is the paper's second
topology (branchy — exercises the Split-node path of the NL Extender).

A topology is a list of ``core.fusion.Node``; tensors are named by the node
that produces them.
"""
from __future__ import annotations

from repro_torch.core.fusion import Node

# Paper Table I: (C, K, H, W, R, S, stride) per distinct ResNet-50 conv layer.
RESNET50_LAYERS = {
    1:  dict(c=3,    k=64,   h=224, w=224, r=7, s=7, stride=2),
    2:  dict(c=64,   k=256,  h=56,  w=56,  r=1, s=1, stride=1),
    3:  dict(c=64,   k=64,   h=56,  w=56,  r=1, s=1, stride=1),
    4:  dict(c=64,   k=64,   h=56,  w=56,  r=3, s=3, stride=1),
    5:  dict(c=256,  k=64,   h=56,  w=56,  r=1, s=1, stride=1),
    6:  dict(c=256,  k=512,  h=56,  w=56,  r=1, s=1, stride=2),
    7:  dict(c=256,  k=128,  h=56,  w=56,  r=1, s=1, stride=2),
    8:  dict(c=128,  k=128,  h=28,  w=28,  r=3, s=3, stride=1),
    9:  dict(c=128,  k=512,  h=28,  w=28,  r=1, s=1, stride=1),
    10: dict(c=512,  k=128,  h=28,  w=28,  r=1, s=1, stride=1),
    11: dict(c=512,  k=1024, h=28,  w=28,  r=1, s=1, stride=2),
    12: dict(c=512,  k=256,  h=28,  w=28,  r=1, s=1, stride=2),
    13: dict(c=256,  k=256,  h=14,  w=14,  r=3, s=3, stride=1),
    14: dict(c=256,  k=1024, h=14,  w=14,  r=1, s=1, stride=1),
    15: dict(c=1024, k=256,  h=14,  w=14,  r=1, s=1, stride=1),
    16: dict(c=1024, k=2048, h=14,  w=14,  r=1, s=1, stride=2),
    17: dict(c=1024, k=512,  h=14,  w=14,  r=1, s=1, stride=2),
    18: dict(c=512,  k=512,  h=7,   w=7,   r=3, s=3, stride=1),
    19: dict(c=512,  k=2048, h=7,   w=7,   r=1, s=1, stride=1),
    20: dict(c=2048, k=512,  h=7,   w=7,   r=1, s=1, stride=1),
}


def _conv(name, inp, c, k, r, stride, *, pad=None):
    pad = (r // 2) if pad is None else pad
    return Node(name, "conv", [inp],
                dict(c=c, k=k, r=r, s=r, stride=stride, padding=pad))


def _bn(name, inp, k):
    return Node(name, "bn", [inp], dict(k=k))


def _relu(name, inp):
    return Node(name, "relu", [inp], {})


def _bottleneck(nodes, prefix, inp, c_in, c_mid, c_out, stride):
    """ResNet-v1.5 bottleneck: 1x1 -> 3x3(stride) -> 1x1 + projection."""
    n = nodes.append
    n(_conv(f"{prefix}_c1", inp, c_in, c_mid, 1, 1))
    n(_bn(f"{prefix}_b1", f"{prefix}_c1", c_mid))
    n(_relu(f"{prefix}_r1", f"{prefix}_b1"))
    n(_conv(f"{prefix}_c2", f"{prefix}_r1", c_mid, c_mid, 3, stride))
    n(_bn(f"{prefix}_b2", f"{prefix}_c2", c_mid))
    n(_relu(f"{prefix}_r2", f"{prefix}_b2"))
    n(_conv(f"{prefix}_c3", f"{prefix}_r2", c_mid, c_out, 1, 1))
    n(_bn(f"{prefix}_b3", f"{prefix}_c3", c_out))
    skip = inp
    if stride != 1 or c_in != c_out:
        n(_conv(f"{prefix}_proj", inp, c_in, c_out, 1, stride))
        n(_bn(f"{prefix}_projbn", f"{prefix}_proj", c_out))
        skip = f"{prefix}_projbn"
    n(Node(f"{prefix}_add", "add", [f"{prefix}_b3", skip], {}))
    n(_relu(f"{prefix}_out", f"{prefix}_add"))
    return f"{prefix}_out"


def resnet50(num_classes: int = 1000, *, stages=(3, 4, 6, 3)) -> list[Node]:
    nodes: list[Node] = [Node("input", "input", [], dict(c=3))]
    nodes.append(_conv("conv1", "input", 3, 64, 7, 2, pad=3))
    nodes.append(_bn("bn1", "conv1", 64))
    nodes.append(_relu("relu1", "bn1"))
    nodes.append(Node("pool1", "maxpool", ["relu1"],
                      dict(window=3, stride=2, padding=1)))
    x = "pool1"
    c_in = 64
    for si, (blocks, c_mid) in enumerate(zip(stages, (64, 128, 256, 512))):
        c_out = c_mid * 4
        for b in range(blocks):
            stride = 2 if (b == 0 and si > 0) else 1
            x = _bottleneck(nodes, f"s{si}b{b}", x, c_in, c_mid, c_out, stride)
            c_in = c_out
    nodes.append(Node("gap", "avgpool", [x], dict(global_pool=True)))
    nodes.append(Node("fc", "fc", ["gap"], dict(c=c_in, k=num_classes)))
    return nodes


def _inception_block(nodes, prefix, inp, c_in, spec):
    """One Inception-v3-style mixed block; spec maps branch -> channel list."""
    outs = []
    for bname, convs in spec.items():
        x = inp
        c = c_in
        for i, (k, r, stride) in enumerate(convs):
            nm = f"{prefix}_{bname}{i}"
            nodes.append(_conv(nm, x, c, k, r, stride))
            nodes.append(_bn(nm + "bn", nm, k))
            nodes.append(_relu(nm + "rl", nm + "bn"))
            x, c = nm + "rl", k
        outs.append((x, c))
    cname = f"{prefix}_cat"
    nodes.append(Node(cname, "concat", [o for o, _ in outs], {}))
    return cname, sum(c for _, c in outs)


def inception_v3(num_classes: int = 1000) -> list[Node]:
    """Inception-v3 style topology (stem + mixed blocks).  Branch structure
    matches the paper's benchmark usage (multi-consumer tensors -> Split
    nodes in the NL Extender)."""
    nodes: list[Node] = [Node("input", "input", [], dict(c=3))]
    stem = [("stem1", 3, 32, 3, 2), ("stem2", 32, 32, 3, 1),
            ("stem3", 32, 64, 3, 1)]
    x = "input"
    for nm, c, k, r, st in stem:
        nodes.append(_conv(nm, x, c, k, r, st))
        nodes.append(_bn(nm + "bn", nm, k))
        nodes.append(_relu(nm + "rl", nm + "bn"))
        x = nm + "rl"
    nodes.append(Node("pool1", "maxpool", [x],
                      dict(window=3, stride=2, padding=1)))
    x, c = "pool1", 64
    mixed = {
        "b1x1": [(64, 1, 1)],
        "b5x5": [(48, 1, 1), (64, 5, 1)],
        "b3x3": [(64, 1, 1), (96, 3, 1), (96, 3, 1)],
        "bproj": [(32, 1, 1)],
    }
    for i in range(3):
        x, c = _inception_block(nodes, f"mix{i}", x, c, mixed)
    nodes.append(Node("gap", "avgpool", [x], dict(global_pool=True)))
    nodes.append(Node("fc", "fc", ["gap"], dict(c=c, k=num_classes)))
    return nodes
