"""The 3xTF32 products of ``csrc/conv_tf32.cuh`` emulated in plain torch,
shared by the CPU tests of the mma routes that use them (K1, K10a:
``tests/test_torch_conv_mma.py``; K4: ``tests/test_torch_streams_mma.py``).

``stage_run`` is one ``stage_products`` call: tf32 rounding (``cvt.rna``)
by integer operations on the f32 bits, the split v = hi + lo, the three
products lo*hi, hi*lo, hi*hi of every 8-channel step summed exactly and
rounded to f32 under a model of the tensor cores' adder (to nearest, or
toward zero), into a zeroed run accumulator that the caller adds to its
f32 sums.
"""
import torch

from repro_torch.kernels.conv2d_direct import MMA_STAGE_C as STAGE


def tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 bits: round the 13 low mantissa bits to
    nearest, ties away from zero (the sign is apart from the magnitude, so
    adding half a step to the bits rounds the magnitude up on a tie)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def to_f32(x64: torch.Tensor, adder: str) -> torch.Tensor:
    """An exact float64 sum rounded to f32: to nearest ("rn") or toward
    zero ("rz")."""
    r = x64.float()
    if adder == "rz":
        over = r.double().abs() > x64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def stage_run(a, b, adder):
    """One stage_products call: a (pixels, depth) and b (depth, K) f32, the
    depth STAGE or a smaller multiple of 8 -> the run accumulator (pixels,
    K) after depth / 8 steps of 8 channels, each step's lo*hi, hi*lo, hi*hi
    mma summed exactly into the f32 run and rounded by ``adder``."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    pairs = [(x_.double(), y_.double()) for x_, y_ in
             ((al, bh), (ah, bl), (ah, bh))]
    run = torch.zeros((a.shape[0], b.shape[1]))
    for kk in range(0, a.shape[1], 8):
        for at, bt in pairs:
            run = to_f32(run.double() + at[:, kk:kk + 8] @ bt[kk:kk + 8],
                         adder)
    return run
