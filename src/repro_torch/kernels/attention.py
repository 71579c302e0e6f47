"""K7: blocked (flash-style) attention with an online softmax.

Replaces ``repro/kernels/attention.py:flash_attention`` (the Pallas
``_kernel``, ``pallas_call`` at :87).  It computes softmax(scale * Q Kᵀ
[causal mask]) V for q (B,Hq,L,Dh) and k, v (B,Hkv,L,Dh); query head h
reads KV head h // (Hq / Hkv) (GQA, the reference's ``bh // rep``).  Logits
and the accumulator are f32; the output has q's dtype (f32 or bf16).

Two versions live here:

* ``flash_attention_plain``: the same function in plain PyTorch,
  ``ref.attention_chunked``: a full f32 softmax over each query chunk (512
  queries at a time once L >= 1024, so the (L, L) logits never exist
  whole), with the kernel's finite ``-1e30`` causal mask.  The CPU tests
  and the CPU path run it; ``chip_smoke.py`` holds the kernel against it.
* the CUDA C++ kernel ``csrc/flash_attention.cu``, built for sm_90a.

``flash_attention`` takes the plain version for a CPU tensor and launches
the kernel for a CUDA tensor; there is no fallback between them.
``launches`` counts the kernel's launches.

Unlike the Pallas kernel, whose blocks must divide L, the CUDA kernel masks
its query and key tails and takes every L >= 1 (a one-token prompt gives
L = 1).  It takes Dh of 16, 64 or 128 (the smoke configs' 16, the served
configs' 64 and 128).

What bounds it on an H100: causal attention does about 2 Dh L² FLOP per
query head against about 4 Dh L bytes of bf16 q and output (plus k and v,
shared by the heads of a group): some L / 2 FLOP per byte, about 440 at
L = 1024 with Qwen2-1.5B's heads, above the ridge in f32 and in bf16, so
the bound is the arithmetic rate.  The kernel runs its products on the SIMT
cores in f32 (67 TFLOP/s); bf16 inputs are widened on load, so against the
bf16 tensor-core peak it is far from its bound.  Its design keeps the
(64, Dh) output tile and the running max and sum in registers, stages one
64-key block of K (transposed) and V in shared memory at a time, and stops
at the diagonal when causal, the skip of the reference's ``pl.when``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernel since the last reset (set it to 0 to reset).
launches = 0
_fn = None

HEAD_DIMS = (16, 64, 128)   # the kernel's template instances
PLAIN_CHUNK = 512           # queries per chunk of the plain version
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q, k, v):
    """Shapes every path needs; returns rep = Hq / Hkv."""
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q, k, v must be (B,H,L,Dh); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, hq, l, dh = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (l, dh):
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if k.shape[1] < 1 or hq % k.shape[1]:
        raise ValueError(f"Hq={hq} is not a multiple of Hkv={k.shape[1]}")
    return hq // k.shape[1]


def flash_attention_plain(q, k, v, *, causal: bool = True, scale=None):
    """The kernel's function in plain PyTorch: ``ref.attention_chunked``,
    one chunk below L = 1024 and ``PLAIN_CHUNK`` queries from there."""
    _check(q, k, v)
    l = q.shape[2]
    return ref.attention_chunked(q, k, v, causal=causal, scale=scale,
                                 chunk=PLAIN_CHUNK if l >= 1024 else l)


def _kernel_fn():
    global _fn
    if _fn is None:
        fn = _build.load("flash_attention").repro_flash_attention
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,Hq,L,Dh), k/v: (B,Hkv,L,Dh) -> (B,Hq,L,Dh) in q's dtype.  A CPU
    tensor takes ``flash_attention_plain``; a CUDA tensor launches the
    sm_90a kernel on the current stream or raises."""
    global launches
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    b, hq, l, dh = q.shape
    if dh not in HEAD_DIMS:
        raise ValueError(f"the kernel takes Dh in {HEAD_DIMS}, got {dh}")
    if q.dtype not in _DTYPES:
        raise ValueError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if scale is None:
        scale = dh ** -0.5
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launches += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                 hq, k.shape[1], l, dh, float(scale), int(causal),
                 _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    return out
