"""K1: direct-convolution forward with the fused §II-G epilogue.

Replaces ``repro/kernels/conv2d_direct.py:conv2d_direct`` (the Pallas
``_kernel_tiled``, ``pallas_call`` at :295).  It computes
``out = relu?(scale*conv(x, w) + shift + bias + residual)`` with x (N,H,W,C),
w (R,S,C,K) and out (N,P,Q,K), accumulating in f32.

Two versions live here:

* ``conv2d_direct_plain`` repeats the kernel's arithmetic in PyTorch: pad,
  then one strided slice and one (pixels, C) x (C, K) matmul per (r, s),
  summed in f32, then the epilogue.  The CPU tests run it, and
  ``chip_smoke.py`` holds the kernel against it on the card.
* the CUDA C++ kernel ``csrc/conv2d_direct.cu``, built for sm_90a.

``conv2d_direct`` takes the plain version for a CPU tensor and launches the
kernel for a CUDA tensor; there is no fallback between them.  ``launches``
counts the kernel's launches.

K10a, the same function by the reference's legacy whole-plane strategy
(``repro/kernels/conv2d_direct.py:_conv2d_whole_plane``, ``pallas_call`` at
:338), lives here too: ``conv2d_direct_whole`` and its plain version
``conv2d_direct_whole_plain``, over the padded plane ``pad_input`` makes,
with the kernel ``csrc/conv2d_direct_whole.cu`` and its own counter
``launches_whole``.  One block computes one output block, an image, k_blk
channels and rb_p rows by the full row Q, and runs over all of C itself.
The TPU keeps the plane resident in VMEM; on the card the plane stays in
L2 (a ResNet-50 plane is at most 3.4 MB of its 50 MB), and the block
stages the input rows it reads in slices of 8 channels in shared memory.

What bounds it on an H100: at ResNet-50's batch-16 shapes nearly every conv
does more than 20 FLOP per byte it must move, above the f32 ridge of
67 TFLOP/s over 3.35 TB/s, so the bound is the SIMT cores' f32 FMA rate.
The design answers with the paper's register blocking: each thread keeps an
8x8 (or 8x4, 4x4 on small planes) tile of outputs in registers and reuses
every staged input and weight value 8 (or 4) times, from a double-buffered
shared-memory slice of one (r, s) and 8 input channels.  Tensor cores
(TF32, bf16) would raise the ceiling but break the f32 parity the
reference holds; they are later work.
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None
# Launches of the whole-plane kernel K10a since the last reset.
launches_whole = 0
_fn_whole = None

SMEM_LIMIT = 232448         # bytes of shared memory one block may claim (H100)
WHOLE_THREADS = 256         # threads per block of the whole-plane kernels
WHOLE_BN = (32, 64, 128)    # output channels a block holds: k_blk rounded up
WHOLE_TM = (4, 8, 12)       # output pixels per thread in one pass
WHOLE_TN = 8                # output channels per thread


@dataclasses.dataclass(frozen=True)
class FuseSpec:
    """Static description of the fused epilogue (paper §II-G L() operators)."""
    bias: bool = False
    bn: bool = False          # folded inference BN: scale * y + shift
    residual: bool = False
    relu: bool = False


def _out_hw(h, w, r, s, stride, padding):
    return ((h + 2 * padding - r) // stride + 1,
            (w + 2 * padding - s) // stride + 1)


def _epilogue(acc, fuse: FuseSpec, bias, scale, shift, residual):
    """The §II-G L() chain in the reference's order: scale, shift, bias,
    residual, relu."""
    if fuse.bn:
        acc = acc * scale
        acc = acc + shift
    if fuse.bias:
        acc = acc + bias
    if fuse.residual:
        acc = acc + residual
    if fuse.relu:
        acc = torch.clamp_min(acc, 0)
    return acc


def conv2d_direct_plain(x, w, *, stride: int = 1, padding: int = 0,
                        bias=None, scale=None, shift=None, residual=None,
                        relu: bool = False):
    """The kernel's arithmetic in plain PyTorch (f32 operands)."""
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = F.pad(x, (0, 0, padding, padding, padding, padding))
    acc = torch.zeros((n * p * q, k), dtype=torch.float32, device=x.device)
    for rr in range(r):
        for ss in range(s):
            xs = xp[:, rr:rr + (p - 1) * stride + 1:stride,
                    ss:ss + (q - 1) * stride + 1:stride, :]
            acc += xs.reshape(n * p * q, c) @ w[rr, ss]
    out = acc.reshape(n, p, q, k)
    return _epilogue(out, fuse, bias, scale, shift, residual)


def pad_input(x, *, padding: int, stride: int, rb_p: int, r: int, p: int):
    """The reference's ``pad_input`` for the whole-plane kernels: x
    (N,H,W,C) padded by ``padding`` on every side but the bottom, which
    gets exactly the rows the ceil-div grid's last rb_p-row block reads
    (for stride > 1 often fewer than ``padding``)."""
    h = x.shape[1]
    rows_needed = (-(-p // rb_p) * rb_p - 1) * stride + r
    pad_bottom = max(rows_needed - (h + padding), 0)
    return F.pad(x, (0, 0, padding, padding, padding, pad_bottom))


@dataclasses.dataclass(frozen=True)
class WholePlan:
    """How a whole-plane kernel (K10a, K10c) runs one conv: ``bn`` output
    channels per block (k_blk rounded up to an instance of the source),
    ``tm`` output pixels per thread, ``rows_pass`` output rows per pass
    over C (the whole block when its rb_p x Q pixels fit the threads' tiles,
    else as many rows as do), and the dynamic shared memory of the two
    staging buffers."""
    bn: int
    tm: int
    rows_pass: int
    smem: int


def whole_plan(*, p: int, q: int, k_blk: int, rb_p: int, r: int, s: int,
               stride: int, wp: int, slice_bytes: int) -> WholePlan:
    """A pure function of the shape.  ``slice_bytes`` is what one staged
    slice of C holds per input pixel and per (tap, output channel) pair:
    8 f32 channels (K10a) or 32 int8 channels (K10c), 32 bytes either way.
    Raises ``ValueError`` when a row of Q pixels exceeds the threads'
    tiles or the two buffers exceed ``SMEM_LIMIT``."""
    bn = next((b for b in WHOLE_BN if b >= k_blk), None)
    if bn is None or k_blk % WHOLE_TN:
        raise ValueError(f"k_blk {k_blk}: the whole-plane kernels take "
                         f"multiples of {WHOLE_TN} up to {WHOLE_BN[-1]}")
    slots = WHOLE_THREADS // (bn // WHOLE_TN)   # thread rows along pixels
    rows = min(rb_p, p)
    tm = next((t for t in WHOLE_TM if slots * t >= rows * q), None)
    if tm is None:
        tm = WHOLE_TM[-1]
        rows = slots * tm // q
        if rows == 0:
            raise ValueError(f"a row of Q={q} pixels exceeds the "
                             f"{slots * tm} a block's threads hold")
    band = ((rows - 1) * stride + r) * wp * slice_bytes
    smem = 2 * (band + r * s * bn * slice_bytes)
    if smem > SMEM_LIMIT:
        raise ValueError(f"the whole-plane staging needs {smem} bytes of "
                         f"shared memory, more than {SMEM_LIMIT}")
    return WholePlan(bn=bn, tm=tm, rows_pass=rows, smem=smem)


def conv2d_direct_whole_plain(x, w, *, stride: int = 1, padding: int = 0,
                              bias=None, scale=None, shift=None,
                              residual=None, relu: bool = False, rb_p: int,
                              k_blk: int):
    """K10a's arithmetic in plain PyTorch, as the reference's whole-plane
    kernel does it: pad as ``pad_input``, then for each block of rb_p rows
    and the full row Q one (pixels, C) x (C, K) matmul per (r, s), summed
    in f32 (each output column is its own k_blk block's), rows past P
    dropped, then the epilogue in the reference's order."""
    h, wd = x.shape[1:3]
    r, s, _, k = w.shape
    p, q = _out_hw(h, wd, r, s, stride, padding)
    _check_whole_blocking(k, rb_p, k_blk)
    rb_p = min(rb_p, p)
    fuse = FuseSpec(bias=bias is not None, bn=scale is not None,
                    residual=residual is not None, relu=relu)
    xp = pad_input(x, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    out = whole_plane_products(xp, w, rb_p=rb_p, p=p, q=q,
                               stride=stride).contiguous()
    return _epilogue(out, fuse, bias, scale, shift, residual)


def whole_plane_products(xp, w, *, rb_p: int, p: int, q: int, stride: int):
    """The whole-plane kernels' products over the padded plane ``xp``: for
    each block of rb_p rows and the full row Q, one (pixels, C) x (C, K)
    matmul per (r, s), summed in the dtype of ``xp`` and ``w``; the rows
    the last block computes past P are dropped.  -> (N, P, Q, K)."""
    n, c = xp.shape[0], xp.shape[3]
    r, s, _, k = w.shape
    blocks = []
    for pb in range(-(-p // rb_p)):
        row0 = pb * rb_p * stride
        acc = torch.zeros((n * rb_p * q, k), dtype=xp.dtype, device=xp.device)
        for rr in range(r):
            for ss in range(s):
                xs = xp[:, row0 + rr:row0 + rr + (rb_p - 1) * stride + 1:stride,
                        ss:ss + (q - 1) * stride + 1:stride, :]
                acc += xs.reshape(n * rb_p * q, c) @ w[rr, ss]
        blocks.append(acc.reshape(n, rb_p, q, k))
    return torch.cat(blocks, dim=1)[:, :p]


def _check_whole_blocking(k: int, rb_p: int, k_blk: int) -> None:
    if rb_p < 1 or k_blk < 1 or k % k_blk:
        raise ValueError(f"whole-plane blocking rb_p {rb_p}, k_blk {k_blk} "
                         f"for K={k}: k_blk must divide K")


def _check(x, w, bias, scale, shift, residual, stride, padding):
    """Shapes every path needs; returns (P, Q)."""
    if x.dim() != 4 or w.dim() != 4:
        raise ValueError(f"x must be (N,H,W,C) and w (R,S,C,K); got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    n, h, wd, c = x.shape
    r, s, wc, k = w.shape
    if wc != c:
        raise ValueError(f"w has C={wc}, x has C={c}")
    if stride < 1 or padding < 0:
        raise ValueError(f"stride {stride}, padding {padding}")
    p, q = _out_hw(h, wd, r, s, stride, padding)
    if p < 1 or q < 1:
        raise ValueError(f"empty output plane {p}x{q}")
    if (scale is None) != (shift is None):
        raise ValueError("folded BN needs both scale and shift")
    for name, v in (("bias", bias), ("scale", scale), ("shift", shift)):
        if v is not None and tuple(v.shape) != (k,):
            raise ValueError(f"{name} must be ({k},), got {tuple(v.shape)}")
    if residual is not None and tuple(residual.shape) != (n, p, q, k):
        raise ValueError(f"residual must be {(n, p, q, k)}, got "
                         f"{tuple(residual.shape)}")
    return p, q


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("conv2d_direct").repro_conv2d_direct_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 10 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def conv2d_direct(x, w, *, stride: int = 1, padding: int = 0, bias=None,
                  scale=None, shift=None, residual=None, relu: bool = False):
    """Direct conv fwd + fused epilogue.  x: (N,H,W,C), w: (R,S,C,K) ->
    (N,P,Q,K).  A CPU tensor takes ``conv2d_direct_plain``; a CUDA tensor
    launches the sm_90a kernel on the current stream or raises."""
    global launches
    p, q = _check(x, w, bias, scale, shift, residual, stride, padding)
    if x.device.type == "cpu":
        return conv2d_direct_plain(x, w, stride=stride, padding=padding,
                                   bias=bias, scale=scale, shift=shift,
                                   residual=residual, relu=relu)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct runs on cpu or cuda, not {x.device}")
    extras = [v for v in (bias, scale, shift, residual) if v is not None]
    for name, v in (("x", x), ("w", w), *(("epilogue operand", e)
                                           for e in extras)):
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, wd, c = x.shape
    r, s, _, k = w.shape
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches += 1
        err = fn(x.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift),
                 ptr(bias), ptr(residual), out.data_ptr(), n, h, wd, c, k, r,
                 s, stride, padding, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct kernel launch failed: CUDA error "
                           f"{err} (x {tuple(x.shape)}, w {tuple(w.shape)})")
    return out


def _kernel_fn_whole():
    global _fn_whole
    if _fn_whole is None:
        fn = _build.load("conv2d_direct_whole").repro_conv2d_direct_whole_f32
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 17 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_whole = fn
    return _fn_whole


def _aligned(t):
    """``t`` itself when its data is 16-byte aligned, else an aligned copy
    (the kernels read 16 bytes at a time)."""
    return t if t is None or t.data_ptr() % 16 == 0 else t.clone()


def conv2d_direct_whole(x, w, *, stride: int = 1, padding: int = 0,
                        bias=None, scale=None, shift=None, residual=None,
                        relu: bool = False, rb_p: int, k_blk: int):
    """K10a: direct conv fwd + fused epilogue by the whole-plane strategy,
    with the reference's blocking (``rb_p`` output rows by the full row Q,
    ``k_blk`` output channels per block).  x: (N,H,W,C), w: (R,S,C,K) ->
    (N,P,Q,K).  A CPU tensor takes ``conv2d_direct_whole_plain``; a CUDA
    tensor launches the sm_90a kernel on the current stream or raises."""
    global launches_whole
    p, q = _check(x, w, bias, scale, shift, residual, stride, padding)
    k = w.shape[3]
    _check_whole_blocking(k, rb_p, k_blk)
    kw = dict(stride=stride, padding=padding, bias=bias, scale=scale,
              shift=shift, residual=residual, relu=relu)
    if x.device.type == "cpu":
        return conv2d_direct_whole_plain(x, w, rb_p=rb_p, k_blk=k_blk, **kw)
    if x.device.type != "cuda":
        raise ValueError(f"conv2d_direct_whole runs on cpu or cuda, not "
                         f"{x.device}")
    extras = [v for v in (bias, scale, shift, residual) if v is not None]
    for name, v in (("x", x), ("w", w), *(("epilogue operand", e)
                                           for e in extras)):
        if v.device != x.device:
            raise ValueError(f"{name} on {v.device}, x on {x.device}")
        if v.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {v.dtype}")
        if not v.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    n, h, wd, c = x.shape
    r, s = w.shape[:2]
    if c % 8:
        raise ValueError(f"C={c}: the whole-plane kernel stages 8 input "
                         f"channels at a time")
    rb_p = min(rb_p, p)
    xp = pad_input(x, padding=padding, stride=stride, rb_p=rb_p, r=r, p=p)
    hp, wp = xp.shape[1], xp.shape[2]
    plan = whole_plan(p=p, q=q, k_blk=k_blk, rb_p=rb_p, r=r, s=s,
                      stride=stride, wp=wp, slice_bytes=32)
    out = torch.empty((n, p, q, k), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    w, residual = _aligned(w), _aligned(residual)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    fn = _kernel_fn_whole()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        launches_whole += 1
        err = fn(xp.data_ptr(), w.data_ptr(), ptr(scale), ptr(shift),
                 ptr(bias), ptr(residual), out.data_ptr(), n, hp, wp, c, k,
                 r, s, stride, p, q, rb_p, k_blk, plan.rows_pass, plan.bn,
                 plan.tm, plan.smem, int(relu), stream)
    if err != 0:
        raise RuntimeError(f"conv2d_direct_whole kernel launch failed: CUDA "
                           f"error {err} (x {tuple(x.shape)}, w "
                           f"{tuple(w.shape)}, {plan})")
    return out
