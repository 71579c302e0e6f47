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
* the CUDA C++ kernels of ``csrc/flash_attention.cu``, built for sm_90a,
  one per route (``route``, by dtype, head width, layout and alignment):
  ``"wgmma"`` for bf16 q, k, v with Dh 64 or 128, contiguous and 16-byte
  aligned, a Hopper kernel on the bf16 tensor cores (TMA loads of q and of
  K/V blocks into a 2-stage ring, ``wgmma`` for S = Q Kᵀ and for P V with
  P in registers, the online softmax in f32 between them; 64 queries a
  block, keys per step ``wgmma_key_block``); ``"simt"`` for f32 (held to
  1e-5) and bf16 off that rule (Dh 16, the smoke configs'), f32 products
  on the SIMT cores.

``flash_attention`` takes the plain version for a CPU tensor and launches
the route's kernel for a CUDA tensor; there is no fallback between them,
nor between the routes: a launch that fails raises.  ``launches`` counts
the launches of both kernels, ``launches_wgmma`` those of the wgmma route.

Unlike the Pallas kernel, whose blocks must divide L, the CUDA kernels mask
their query and key tails and take every L >= 1 (a one-token prompt gives
L = 1).  They take Dh of 16 (simt), 64 or 128 (the smoke configs' 16, the
served configs' 64 and 128).

What bounds it on an H100: causal attention does about 2 Dh L² FLOP per
query head against about 4 Dh L bytes of bf16 q and output (plus k and v,
shared by the heads of a group): some L / 2 FLOP per byte, about 440 at
L = 1024 with Qwen2-1.5B's heads, above the ridge in f32 and in bf16, so
the bound is the arithmetic rate: 989 TFLOP/s on the bf16 tensor cores,
67 TFLOP/s f32 on the SIMT cores.  Both kernels keep the output tile and
the running max and sum in registers, stream one block of K and V at a
time, and stop at the diagonal when causal, the skip of the reference's
``pl.when``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, ref

# Launches of the CUDA kernels since the last reset (set it to 0 to reset):
# both routes, and the wgmma route's alone.
launches = 0
launches_wgmma = 0
_fn = None
_fn_wgmma = None

HEAD_DIMS = (16, 64, 128)   # the SIMT kernel's template instances
WGMMA_HEAD_DIMS = (64, 128)
KEY_BLOCKS = (64, 128)      # the wgmma kernel's keys per step
SMS = 132                   # an H100 SXM's streaming multiprocessors
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


def route(q, k, v) -> str:
    """Which kernel a CUDA call of ``flash_attention(q, k, v)`` launches, by
    dtype, head width, layout and alignment alone: "wgmma" for bf16 q, k
    and v with Dh 64 or 128, all contiguous and 16-byte aligned (TMA's
    bases; the output the wrapper allocates always is), else "simt".  A
    dispatch by shape, not a fallback: each route raises on failure."""
    ts = (q, k, v)
    if (all(t.dtype == torch.bfloat16 for t in ts)
            and q.shape[-1] in WGMMA_HEAD_DIMS
            and all(t.is_contiguous() and t.data_ptr() % 16 == 0
                    for t in ts)):
        return "wgmma"
    return "simt"


def wgmma_key_block(b: int, hq: int, l: int, causal: bool) -> int:
    """Keys per step of the wgmma kernel's loop: 128 (one block an SM by
    shared memory, half the steps) for a causal prompt of 512 tokens or
    more whose 64-query blocks fit twice on the card's SMs; else 64 (two
    blocks an SM).  The rule follows the device times of both that
    ``chip_smoke.py`` (phase 14) takes at every bf16 shape (PERF.md): the
    long causal batch-1 prompt gains from the shorter loop, a grid of
    several waves or a short prompt from two blocks an SM."""
    blocks = b * hq * -(-l // 64)
    return 128 if causal and l >= 512 and blocks <= 2 * SMS else 64


def _kernel_fn_wgmma():
    global _fn_wgmma
    if _fn_wgmma is None:
        fn = _build.load("flash_attention").repro_flash_attention_wgmma
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_wgmma = fn
    return _fn_wgmma


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
    sm_90a kernel of its ``route`` on the current stream or raises."""
    global launches, launches_wgmma
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
    path = route(q, k, v)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
                hq, k.shape[1], l, dh, float(scale), int(causal))
        if path == "wgmma":
            fn = _kernel_fn_wgmma()
            launches += 1
            launches_wgmma += 1
            err = fn(*args, wgmma_key_block(b, hq, l, causal), stream)
        else:
            fn = _kernel_fn()
            launches += 1
            err = fn(*args, _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed ({path} "
                           f"route): CUDA error {err} (q {tuple(q.shape)}, "
                           f"k {tuple(k.shape)}, {q.dtype})")
    return out
