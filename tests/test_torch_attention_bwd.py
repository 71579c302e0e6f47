"""K7's backward on the CPU: ``flash_attention_bwd_plain`` (the backward
kernel's function written out in plain f32 PyTorch) against torch autograd
of ``flash_attention_plain`` and against ``jax.grad`` of the reference's
``repro.kernels.ref.attention_chunked`` (the function K7 computes, whose
gradient the reference's training takes from XLA), causal and not, with
GQA and ragged L; the CPU dispatch of ``flash_attention_bwd`` and
``route_bwd`` (its rule on CPU tensors) and ``wgmma_bwd_plan``; the rows'
log-sum-exp that the wgmma forward saves (``lse_plain``, ``return_lse``)
against ``jax.nn.logsumexp`` of the reference's masked logits, and the
plain backward given it; and ``_build.no_grad_inputs``, which the CUDA
wrappers without a backward call.

Tolerance: max |diff| <= 1e-5 * max |ref| per gradient (f32; the sums run
in other orders); lse within 1e-5 relative; the backward with lse within
1e-6 of max |plain| of the one without (exp(s - lse) against the softmax).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jax_ref
from repro_torch.kernels import _build
from repro_torch.kernels import attention as k7

TOL = 1e-5

# b, hq, hkv, l, dh: GQA 3 and 1, ragged L, a chunked L (>= 1024 takes
# PLAIN_CHUNK queries at a time), the smoke configs' Dh 16
CASES = [(2, 6, 2, 37, 16), (1, 4, 4, 20, 64), (1, 2, 1, 1029, 16)]


def _inputs(case, seed=0):
    b, hq, hkv, l, dh = case
    rng = np.random.default_rng(seed)

    def rnd(*shape):
        return rng.standard_normal(shape).astype(np.float32)
    return rnd(b, hq, l, dh), rnd(b, hkv, l, dh), rnd(b, hkv, l, dh), \
        rnd(b, hq, l, dh)


def _rel(out, exp) -> float:
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    exp = np.asarray(exp)
    return float(np.abs(out - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_matches_autograd_and_reference(case, causal):
    q, k, v, do = _inputs(case)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    out = k7.flash_attention_plain(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(do))
    got = k7.flash_attention_bwd_plain(
        *(torch.from_numpy(t) for t in (q, k, v)), out.detach(),
        torch.from_numpy(do), causal=causal)
    _, vjp = jax.vjp(lambda a, b_, c: jax_ref.attention_chunked(
        a, b_, c, causal=causal), jnp.asarray(q), jnp.asarray(k),
        jnp.asarray(v))
    exp = vjp(jnp.asarray(do))
    for name, g, auto, ref in zip(("dq", "dk", "dv"), got,
                                  (qt.grad, kt.grad, vt.grad), exp):
        assert g.shape == auto.shape and g.dtype == torch.float32
        assert _rel(g, auto.numpy()) <= TOL, name
        assert _rel(g, ref) <= TOL, name


def test_plain_backward_keeps_dtypes_and_scale():
    q, k, v, do = _inputs((1, 2, 2, 9, 16), 1)
    bf = [torch.from_numpy(t).to(torch.bfloat16) for t in (q, k, v, do)]
    out = k7.flash_attention_plain(*bf[:3], scale=0.3)
    grads = k7.flash_attention_bwd_plain(*bf[:3], out, bf[3], scale=0.3)
    assert all(g.dtype == torch.bfloat16 for g in grads)
    qt, kt, vt = (torch.from_numpy(t).requires_grad_() for t in (q, k, v))
    k7.flash_attention_plain(qt, kt, vt, scale=0.3).backward(
        torch.from_numpy(do))
    f32 = k7.flash_attention_bwd_plain(
        *(torch.from_numpy(t) for t in (q, k, v)),
        k7.flash_attention_plain(*(torch.from_numpy(t) for t in (q, k, v)),
                                 scale=0.3),
        torch.from_numpy(do), scale=0.3)
    assert _rel(f32[0], qt.grad.numpy()) <= TOL


def test_cpu_dispatch_and_route():
    q, k, v, do = (torch.from_numpy(t) for t in _inputs((1, 4, 2, 11, 16)))
    o = k7.flash_attention(q, k, v)
    before = k7.launches_bwd
    got = k7.flash_attention_bwd(q, k, v, o, do)
    exp = k7.flash_attention_bwd_plain(q, k, v, o, do)
    assert all(torch.equal(a, b) for a, b in zip(got, exp))
    assert k7.launches_bwd == before          # no kernel on the CPU
    assert k7.route_bwd(q, k, v) == "simt"
    with pytest.raises(ValueError):
        k7.route_bwd(q[..., :12], k[..., :12], v[..., :12])
    with pytest.raises(ValueError):
        k7.route_bwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        k7.flash_attention_bwd_plain(q, k, v, o[:, :, :5], do)


def test_cpu_autograd_differentiates_the_plain_version():
    q, k, v, _ = (torch.from_numpy(t).requires_grad_()
                  for t in _inputs((1, 2, 1, 6, 16)))
    out = k7.flash_attention(q, k, v)
    assert out.grad_fn is not None
    out.sum().backward()
    assert q.grad is not None and k.grad is not None


def test_no_grad_inputs():
    x = torch.ones(3, requires_grad=True)
    y = torch.ones(3)
    _build.no_grad_inputs("k", y, None)                 # nothing wants grad
    with torch.no_grad():
        _build.no_grad_inputs("k", x, y)                # grad mode off
    with pytest.raises(NotImplementedError, match="no model trains") as err:
        _build.no_grad_inputs("some_kernel (Kx)", y, None, x)
    assert "some_kernel (Kx)" in str(err.value)
    _build.no_grad_inputs("k", x.detach())


def test_route_bwd_rule_on_cpu_tensors():
    """``route_bwd`` is the forward's rule: bf16 at Dh 64 or 128, contiguous
    and 16-byte aligned takes "wgmma"; f32, Dh 16 or a non-contiguous view
    "simt"; what no route takes raises."""
    def qkv(dtype, dh, l=8):
        return [torch.zeros(1, 2, l, dh, dtype=dtype) for _ in range(3)]
    for dh in (64, 128):
        assert k7.route_bwd(*qkv(torch.bfloat16, dh)) == "wgmma"
        assert k7.route_bwd(*qkv(torch.float32, dh)) == "simt"
        q, k, v = qkv(torch.bfloat16, dh)
        q = torch.zeros(1, 8, 2, dh, dtype=torch.bfloat16).transpose(1, 2)
        assert not q.is_contiguous()
        assert k7.route_bwd(q, k, v) == "simt"
    assert k7.route_bwd(*qkv(torch.bfloat16, 16)) == "simt"
    assert k7.route_bwd(*qkv(torch.float32, 16)) == "simt"
    with pytest.raises(ValueError):
        k7.route_bwd(*qkv(torch.float64, 64))
    with pytest.raises(ValueError):
        k7.route_bwd(*qkv(torch.bfloat16, 12))


@pytest.mark.parametrize("shape,plan", [
    ((8, 12, 2, 512, 128), 2),     # Qwen2-1.5B's training shape
    ((8, 15, 5, 512, 64), 1),      # SmolLM-360M's
    ((2, 12, 2, 333, 128), 6),     # a small grid: every head apart
    ((1, 4, 4, 77, 64), 1),        # one query head a KV head
], ids=[f"shape{i}-plan{i}" for i in range(4)])
def test_wgmma_bwd_plan(shape, plan):
    assert k7.wgmma_bwd_plan(*shape) == plan
    assert (shape[1] // shape[2]) % plan == 0


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", [(2, 6, 2, 37, 16), (1, 2, 1, 1029, 16)])
def test_lse_plain_matches_reference_logsumexp(case, causal):
    """Each row's log-sum-exp of scale q kᵀ over its unmasked keys, ragged
    L and a chunked one, against ``jax.nn.logsumexp`` of the reference's
    logits with its -1e30 causal mask."""
    q, k, _, _ = _inputs(case, 3)
    b, hq, hkv, l, dh = case
    kr = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kr) * dh ** -0.5
    if causal:
        pos = jnp.arange(l)
        logits = jnp.where(pos[:, None] >= pos[None, :], logits, -1e30)
    exp = np.asarray(jax.nn.logsumexp(logits, axis=-1))
    got = k7.lse_plain(torch.from_numpy(q), torch.from_numpy(k),
                       causal=causal)
    assert got.shape == (b, hq, l) and got.dtype == torch.float32
    assert float(np.abs(got.numpy() - exp).max() / np.abs(exp).max()) <= TOL
    qt, kt, vt = (torch.from_numpy(t) for t in _inputs(case, 3)[:3])
    out, lse = k7.flash_attention_plain(qt, kt, vt, causal=causal,
                                        return_lse=True)
    assert torch.equal(out, k7.flash_attention_plain(qt, kt, vt,
                                                     causal=causal))
    assert torch.equal(lse, got)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_plain_backward_with_lse_equals_without(case, causal):
    q, k, v, do = (torch.from_numpy(t) for t in _inputs(case, 4))
    o, lse = k7.flash_attention_plain(q, k, v, causal=causal,
                                      return_lse=True)
    without = k7.flash_attention_bwd_plain(q, k, v, o, do, causal=causal)
    given = k7.flash_attention_bwd_plain(q, k, v, o, do, causal=causal,
                                         lse=lse)
    via = k7.flash_attention_bwd(q, k, v, o, do, causal=causal, lse=lse)
    for name, a, b_, c in zip(("dq", "dk", "dv"), given, without, via):
        assert _rel(a, b_.numpy()) <= 1e-6, name
        assert torch.equal(a, c), name
    with pytest.raises(ValueError):
        k7.flash_attention_bwd_plain(q, k, v, o, do, lse=lse[:, :1])
