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

Its gradient.  The reference's Pallas kernel has no ``custom_vjp``: its
training step differentiates ``ref.attention_chunked`` with XLA's
autodiff.  On the CPU autograd differentiates the plain version the same
way.  On the card, where q, k or v requires grad under grad mode,
``flash_attention`` runs the forward kernel inside a
``torch.autograd.Function`` whose backward is K7's backward kernel,
``flash_attention_bwd`` (``csrc/flash_attention_bwd.cu``: a dq kernel that
also writes each row's log-sum-exp and delta = rowsum(dout o), then a dk/dv
kernel that sums the query heads of each KV head inside its block; f32
FMA on the SIMT cores, no atomics).  ``flash_attention_bwd_plain`` is the
same backward in plain f32 PyTorch, written out; the tests and
``chip_smoke.py`` hold the kernel against it.  ``launches_bwd`` counts the
backward's calls (two kernels each); ``route_bwd`` raises on what the
kernel cannot take.

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
# both forward routes, the wgmma route's alone, and the backward's.
launches = 0
launches_wgmma = 0
launches_bwd = 0
_fn = None
_fn_wgmma = None
_fn_bwd = None

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


def _launch_forward(q, k, v, causal: bool, scale: float):
    """The route's forward kernel on q's device and current stream; the
    checks are the caller's."""
    global launches, launches_wgmma
    b, hq, l, dh = q.shape
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


class _FlashAttention(torch.autograd.Function):
    """K7 forward with K7's backward kernel as its gradient: the forward
    saves q, k, v and its output, the backward launches
    ``flash_attention_bwd``."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out = _launch_forward(q, k, v, causal, scale)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout,
                                         causal=ctx.causal, scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = True, scale=None):
    """q: (B,Hq,L,Dh), k/v: (B,Hkv,L,Dh) -> (B,Hq,L,Dh) in q's dtype.  A CPU
    tensor takes ``flash_attention_plain`` (autograd differentiates it); a
    CUDA tensor launches the sm_90a kernel of its ``route`` on the current
    stream or raises.  On the card, with grad enabled and q, k or v
    requiring grad, the output's gradient is K7's backward kernel
    (``flash_attention_bwd``)."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, scale=scale)
    _check_cuda(q, k, v)
    _check_head(q)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, float(scale))
    return _launch_forward(q, k, v, causal, scale)


def _check_head(q, what: str = "the kernel"):
    """What the SIMT kernels of both directions take: f32 or bf16, Dh in
    ``HEAD_DIMS``."""
    if q.dtype not in _DTYPES:
        raise ValueError(f"{what} takes float32 or bfloat16, got {q.dtype}")
    if q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"{what} takes Dh in {HEAD_DIMS}, got "
                         f"{q.shape[-1]}")


def _check_cuda(*ts):
    """What the CUDA kernels need of q, k, v (and of o and dout in the
    backward): one CUDA device and dtype, contiguous."""
    q = ts[0]
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not "
                         f"{q.device}")
    for name, t in zip(("q", "k", "v", "o", "dout"), ts):
        if t.device != q.device:
            raise ValueError(f"{name} on {t.device}, q on {q.device}")
        if t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype}, q is {q.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


# ---------------------------------------------------------------------------
# K7's backward
# ---------------------------------------------------------------------------

def flash_attention_bwd_plain(q, k, v, o, dout, *, causal: bool = True,
                              scale=None):
    """The backward kernel's function in plain f32 PyTorch, written out (not
    autograd), chunked like ``flash_attention_plain``: per query chunk,
    P = softmax(scale q kᵀ [-1e30 causal mask]), dv += Pᵀ dout, dS =
    P (dout vᵀ - delta) with delta = rowsum(dout o), dq = scale dS k, dk +=
    scale dSᵀ q; k and v repeated over the query heads of their group and
    dk, dv summed back.  Returns (dq, dk, dv) in q's, k's and v's dtypes."""
    rep = _check(q, k, v)
    b, hq, l, dh = q.shape
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    if scale is None:
        scale = dh ** -0.5
    chunk = PLAIN_CHUNK if l >= 1024 else l
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    delta = (dout.float() * o.float()).sum(dim=-1)            # (B,Hq,L)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(kf.shape, dtype=torch.float32, device=q.device)
    dv = torch.zeros(vf.shape, dtype=torch.float32, device=q.device)
    kpos = torch.arange(l, device=q.device)
    for q0 in range(0, l, chunk):
        qi = q[:, :, q0:q0 + chunk].float()
        di = dout[:, :, q0:q0 + chunk].float()
        logits = torch.einsum("bhqd,bhkd->bhqk", qi, kf) * scale
        if causal:
            qpos = q0 + torch.arange(qi.shape[2], device=q.device)
            logits = torch.where(qpos[:, None] >= kpos[None, :], logits,
                                 -1e30)
        p = torch.softmax(logits, dim=-1)
        dv += torch.einsum("bhqk,bhqd->bhkd", p, di)
        dp = torch.einsum("bhqd,bhkd->bhqk", di, vf)
        ds = p * (dp - delta[:, :, q0:q0 + chunk, None])
        dq[:, :, q0:q0 + chunk] = torch.einsum("bhqk,bhkd->bhqd", ds,
                                               kf) * scale
        dk += torch.einsum("bhqk,bhqd->bhkd", ds, qi) * scale
    hkv = k.shape[1]
    dk = dk.reshape(b, hkv, rep, l, dh).sum(dim=2)
    dv = dv.reshape(b, hkv, rep, l, dh).sum(dim=2)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def route_bwd(q, k, v) -> str:
    """Which kernel a CUDA call of ``flash_attention_bwd`` launches: "simt"
    (f32 FMA, ``csrc/flash_attention_bwd.cu``) for f32 or bf16 with Dh in
    ``HEAD_DIMS``; anything else raises ``ValueError``: there is no other
    route and no fallback."""
    _check_head(q, "the backward kernel")
    return "simt"


def _kernel_fn_bwd():
    global _fn_bwd
    if _fn_bwd is None:
        fn = _build.load("flash_attention_bwd").repro_flash_attention_bwd
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 5 \
            + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn_bwd = fn
    return _fn_bwd


def flash_attention_bwd(q, k, v, o, dout, *, causal: bool = True,
                        scale=None):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` whose output was ``o``,
    for the output gradient ``dout``, in the inputs' dtypes.  A CPU tensor
    takes ``flash_attention_bwd_plain``; a CUDA tensor launches the sm_90a
    backward kernels (two, counted as one launch in ``launches_bwd``) on the
    current stream or raises."""
    global launches_bwd
    _check(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, o, dout, causal=causal,
                                         scale=scale)
    dout = dout.contiguous()
    route_bwd(q, k, v)
    _check_cuda(q, k, v, o, dout)
    if o.shape != q.shape or dout.shape != q.shape:
        raise ValueError(f"o {tuple(o.shape)} and dout {tuple(dout.shape)} "
                         f"must have q's shape {tuple(q.shape)}")
    b, hq, l, dh = q.shape
    if scale is None:
        scale = dh ** -0.5
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0:
        return dq, dk, dv
    lse, delta = (torch.empty((b, hq, l), dtype=torch.float32,
                              device=q.device) for _ in range(2))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        fn = _kernel_fn_bwd()
        launches_bwd += 1
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                 lse.data_ptr(), delta.data_ptr(), b, hq, k.shape[1],
                 l, dh, float(scale), int(causal), _DTYPES[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err} (q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype})")
    return dq, dk, dv
