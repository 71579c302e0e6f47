"""The 3xTF32 products of ``csrc/conv_tf32.cuh`` emulated in plain torch,
shared by the CPU tests of the mma routes that use them (K1, K10a:
``tests/test_torch_conv_mma.py``; K4: ``tests/test_torch_streams_mma.py``).

``stage_run`` is one ``stage_products`` call: tf32 rounding (``cvt.rna``)
by integer operations on the f32 bits, the split v = hi + lo, the three
products lo*hi, hi*lo, hi*hi of every 8-channel step summed exactly and
rounded to f32 under a model of the tensor cores' adder (to nearest, or
toward zero), into a zeroed run accumulator that the caller adds to its
f32 sums.

The run is kept in float64 between steps (it holds f32 values, so that is
exact), and rounding toward zero clears the low 29 mantissa bits of the
float64 sum, which is the f32 result wherever it lies in f32's normal
range.  ``stage_run`` checks from its operands that no nonzero sum can
fall below it and otherwise takes ``to_f32``'s general path, so the bits
do not depend on the path.  ``single_thread`` runs a block with one torch
thread: the emulation is a long chain of small operations, which torch's
thread pool slows down many times over where test workers share the
cores.
"""
import contextlib

import torch

from repro_torch.kernels.conv2d_direct import MMA_STAGE_C as STAGE

# the float64 bits below f32's 23-bit mantissa, and f32's least normal
_LOW29 = (1 << 29) - 1
_F32_TINY = 2.0 ** -126


def tf32(v: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 on f32 bits: round the 13 low mantissa bits to
    nearest, ties away from zero (the sign is apart from the magnitude, so
    adding half a step to the bits rounds the magnitude up on a tie)."""
    bits = v.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v (f32) = hi + lo, each a tf32 value, as float64 (hi, lo): a product
    of two is exact in float64."""
    hi = tf32(v)
    return hi.double(), tf32(v - hi).double()


def to_f32(x64: torch.Tensor, adder: str) -> torch.Tensor:
    """An exact float64 sum rounded to f32: to nearest ("rn") or toward
    zero ("rz")."""
    r = x64.float()
    if adder == "rz":
        over = r.double().abs() > x64.abs()
        r = torch.where(over, torch.nextafter(r, torch.zeros_like(r)), r)
    return r


def _least_ulp(parts) -> float:
    """The least unit in the last place of any nonzero tf32 value among
    ``parts`` (a tf32 value has 10 mantissa bits), or inf if all are 0."""
    least = min(float(torch.where(p != 0, p.abs(), torch.inf).min())
                for p in parts)
    return least * 2.0 ** -11


def _round64(x64: torch.Tensor, adder: str, fast: bool) -> torch.Tensor:
    """``to_f32(x64, adder)`` as float64.  With ``fast`` (no nonzero x64
    below f32's least normal) rounding toward zero is one mask."""
    if adder == "rz" and fast:
        return (x64.view(torch.int64) & ~_LOW29).view(torch.float64)
    return to_f32(x64, adder).double()


def stage_run(a, b, adder):
    """One stage_products call: a (pixels, depth) and b (depth, K) f32, the
    depth STAGE or a smaller multiple of 8 -> the run accumulator (pixels,
    K) after depth / 8 steps of 8 channels, each step's lo*hi, hi*lo, hi*hi
    mma summed exactly into the f32 run and rounded by ``adder``.  b may be
    given already ``split``."""
    ah, al = split(a)
    bh, bl = b if isinstance(b, tuple) else split(b)
    # every product, so every sum and rounded run, is a multiple of the
    # least a-ulp times the least b-ulp: when that is a normal f32, no
    # nonzero run falls below f32's least normal
    fast = _least_ulp((ah, al)) * _least_ulp((bh, bl)) >= _F32_TINY
    steps, k = a.shape[1] // 8, bh.shape[1]
    prods = [torch.bmm(at.reshape(-1, steps, 8).transpose(0, 1),
                       bt.reshape(steps, 8, k))
             for at, bt in ((al, bh), (ah, bl), (ah, bh))]
    run = torch.zeros((a.shape[0], k), dtype=torch.float64)
    for step in range(steps):
        for prod in prods:
            run = _round64(run + prod[step], adder, fast)
    return run.float()


@contextlib.contextmanager
def single_thread():
    """Runs the block with one torch thread and restores the count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)
