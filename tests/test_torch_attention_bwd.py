"""K7's backward on the CPU: ``flash_attention_bwd_plain`` (the backward
kernel's function written out in plain f32 PyTorch) against torch autograd
of ``flash_attention_plain`` and against ``jax.grad`` of the reference's
``repro.kernels.ref.attention_chunked`` (the function K7 computes, whose
gradient the reference's training takes from XLA), causal and not, with
GQA and ragged L; the CPU dispatch of ``flash_attention_bwd`` and
``route_bwd``; and ``_build.no_grad_inputs``, which the CUDA wrappers
without a backward call.

Tolerance: max |diff| <= 1e-5 * max |ref| per gradient (f32; the sums run
in other orders).
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
    with pytest.raises(NotImplementedError, match="item 14") as err:
        _build.no_grad_inputs("some_kernel (Kx)", y, None, x)
    assert "some_kernel (Kx)" in str(err.value)
    _build.no_grad_inputs("k", x.detach())
