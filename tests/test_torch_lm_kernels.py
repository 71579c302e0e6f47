"""The port's LM kernels on the CPU against the JAX package, on the same
numpy inputs: K7's plain version (``flash_attention_plain``), K6's plain
version (``matmul_fused_plain``), the oracles of ``kernels/ref.py`` and the
``ops`` dispatch.

References: ``repro.kernels.ref`` (the xla path) and the Pallas kernels in
interpret mode where their blocks divide the shape (the Pallas K7 asserts
that its blocks divide L, so L = 37 and L = 1 meet the oracle only).
Tolerances: f32 rtol = atol = 1e-5; bf16 inputs max |diff| / max |ref| <=
1e-2 (both sides round the f32 result to bf16 once).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import attention as jax_k7
from repro.kernels import matmul_fused as jax_k6
from repro.kernels import ref as jax_ref
from repro_torch.convert import to_tensor
from repro_torch.kernels import attention as k7
from repro_torch.kernels import matmul_fused as k6
from repro_torch.kernels import ops, ref

F32_TOL = 1e-5
BF16_REL_TOL = 1e-2


def _qkv(seed, b, hq, hkv, l, dh):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, hq, l, dh), (b, hkv, l, dh), (b, hkv, l, dh))]


def _t(arrs, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrs]


def _close(out, exp):
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=F32_TOL,
                               atol=F32_TOL)


def _rel(out, exp) -> float:
    exp = np.asarray(exp, np.float32)
    return float(np.abs(out.float().numpy() - exp).max() / np.abs(exp).max())


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 2), (6, 2)])
def test_flash_plain_matches_reference_and_pallas(causal, hq, hkv):
    arrs = _qkv(hq * 10 + hkv, 2, hq, hkv, 32, 16)
    out = k7.flash_attention_plain(*_t(arrs), causal=causal)
    jq, jk, jv = (jnp.asarray(a) for a in arrs)
    _close(out, jax_ref.attention(jq, jk, jv, causal=causal))
    _close(out, jax_k7.flash_attention(jq, jk, jv, causal=causal, bq=8,
                                       bk=8, interpret=True))


@pytest.mark.parametrize("l", [37, 1])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_any_length(l, causal):
    arrs = _qkv(l, 2, 6, 2, l, 16)
    out = k7.flash_attention_plain(*_t(arrs), causal=causal)
    _close(out, jax_ref.attention(*(jnp.asarray(a) for a in arrs),
                                  causal=causal))


def test_flash_plain_matches_chunked_reference():
    arrs = _qkv(64, 1, 4, 2, 64, 16)
    out = k7.flash_attention_plain(*_t(arrs), causal=True)
    _close(out, jax_ref.attention_chunked(*(jnp.asarray(a) for a in arrs),
                                          causal=True, chunk=16))


def test_flash_plain_chunks_long_sequences(monkeypatch):
    """From L >= 1024 the plain version works in query chunks; the chunked
    result is the unchunked one (a small chunk stands in for 512)."""
    arrs = _qkv(3, 1, 4, 2, 1024, 8)
    full = k7.flash_attention_plain(*_t(arrs), causal=True)
    monkeypatch.setattr(k7, "PLAIN_CHUNK", 96)      # ragged last chunk
    _close(k7.flash_attention_plain(*_t(arrs), causal=True), full.numpy())


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_bf16(causal):
    arrs = _qkv(7, 2, 8, 2, 32, 16)
    out = k7.flash_attention_plain(*_t(arrs, torch.bfloat16), causal=causal)
    assert out.dtype == torch.bfloat16
    jargs = [jnp.asarray(a, jnp.bfloat16) for a in arrs]
    assert _rel(out, jax_ref.attention(*jargs, causal=causal)) <= \
        BF16_REL_TOL
    assert _rel(out, jax_k7.flash_attention(*jargs, causal=causal, bq=8,
                                            bk=8, interpret=True)) <= \
        BF16_REL_TOL


@pytest.mark.parametrize("causal", [True, False])
def test_ref_attention_oracles_match_jax(causal):
    arrs = _qkv(11, 2, 4, 2, 32, 16)
    jargs = [jnp.asarray(a) for a in arrs]
    # one chunk is the reference's full-softmax ``attention``
    _close(ref.attention_chunked(*_t(arrs), causal=causal, chunk=32),
           jax_ref.attention(*jargs, causal=causal))
    _close(ref.attention_chunked(*_t(arrs), causal=causal, chunk=8),
           jax_ref.attention_chunked(*jargs, causal=causal, chunk=8))
    # a chunk that does not divide L: the reference falls back to the full
    # softmax, the port's last chunk is ragged
    _close(ref.attention_chunked(*_t(arrs), causal=causal, chunk=12),
           jax_ref.attention(*jargs, causal=causal))


def _mm(seed, m, k, n):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(s).astype(np.float32)
            for s in ((m, k), (k, n), (n,), (m, n))]


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
@pytest.mark.parametrize("bias,residual", [(False, False), (True, False),
                                           (False, True), (True, True)])
def test_matmul_plain_matches_reference_and_pallas(act, bias, residual):
    a, b, bv, res = _mm(len(act), 64, 96, 32)
    kw = dict(bias=bv if bias else None, residual=res if residual else None)
    tkw = {key: None if v is None else torch.from_numpy(v)
           for key, v in kw.items()}
    jkw = {key: None if v is None else jnp.asarray(v) for key, v in kw.items()}
    out = k6.matmul_fused_plain(torch.from_numpy(a), torch.from_numpy(b),
                                act=act, **tkw)
    _close(out, jax_ref.matmul_fused(jnp.asarray(a), jnp.asarray(b), act=act,
                                     **jkw))
    _close(out, jax_k6.matmul_fused(jnp.asarray(a), jnp.asarray(b), act=act,
                                    bm=32, bn=16, bk=32, interpret=True,
                                    **jkw))


@pytest.mark.parametrize("act", ["none", "relu", "gelu", "silu"])
def test_matmul_plain_bf16(act):
    a, b, bv, res = _mm(5, 64, 96, 32)
    t = [torch.from_numpy(x).to(torch.bfloat16) for x in (a, b, bv, res)]
    j = [jnp.asarray(x, jnp.bfloat16) for x in (a, b, bv, res)]
    out = k6.matmul_fused_plain(t[0], t[1], bias=t[2], residual=t[3],
                                act=act)
    assert out.dtype == torch.bfloat16
    assert _rel(out, jax_ref.matmul_fused(j[0], j[1], bias=j[2],
                                          residual=j[3], act=act)) <= \
        BF16_REL_TOL


def test_matmul_plain_rejects_bad_shapes_and_acts():
    a, b = torch.zeros(4, 8), torch.zeros(8, 3)
    with pytest.raises(ValueError, match="act"):
        k6.matmul_fused_plain(a, b, act="tanh")
    with pytest.raises(ValueError, match="bias"):
        k6.matmul_fused_plain(a, b, bias=torch.zeros(4))
    with pytest.raises(ValueError, match="a must be"):
        k6.matmul_fused_plain(a, torch.zeros(7, 3))


def test_ops_on_cpu_take_the_plain_versions():
    arrs = _qkv(5, 1, 4, 2, 37, 16)
    a, b, bv, res = _mm(6, 24, 40, 12)
    k6.launches = k7.launches = 0
    att = ops.attention(*_t(arrs), causal=True)
    mm = ops.matmul(torch.from_numpy(a), torch.from_numpy(b),
                    bias=torch.from_numpy(bv), act="silu",
                    residual=torch.from_numpy(res))
    assert k6.launches == 0 and k7.launches == 0
    _close(att, k7.flash_attention_plain(*_t(arrs), causal=True).numpy())
    _close(mm, jax_ref.matmul_fused(jnp.asarray(a), jnp.asarray(b),
                                    bias=jnp.asarray(bv), act="silu",
                                    residual=jnp.asarray(res)))


def _offset(m, k, dtype):
    """A contiguous (m, k) view whose data starts one element past a fresh
    allocation: 2 (bf16) or 4 (f32) bytes off TMA's 16-byte alignment."""
    return torch.zeros(m * k + 1, dtype=dtype)[1:].view(m, k)


BF16 = torch.bfloat16
# (a, b) of each case and the route a CUDA call of matmul_fused takes
ROUTE_CASES = {
    "aligned bf16": (lambda: (torch.zeros(64, 96, dtype=BF16),
                              torch.zeros(96, 32, dtype=BF16)), "wgmma"),
    "f32": (lambda: (torch.zeros(64, 96), torch.zeros(96, 32)), "simt"),
    "K % 8 != 0": (lambda: (torch.zeros(64, 90, dtype=BF16),
                            torch.zeros(90, 32, dtype=BF16)), "simt"),
    "N % 8 != 0": (lambda: (torch.zeros(64, 96, dtype=BF16),
                            torch.zeros(96, 36, dtype=BF16)), "simt"),
    "offset a": (lambda: (_offset(64, 96, BF16),
                          torch.zeros(96, 32, dtype=BF16)), "simt"),
    "offset b": (lambda: (torch.zeros(64, 96, dtype=BF16),
                          _offset(96, 32, BF16)), "simt"),
}


@pytest.mark.parametrize("case", list(ROUTE_CASES))
def test_matmul_route_by_shape_dtype_and_alignment(case):
    """``matmul_fused.route``: aligned bf16 with K and N multiples of 8
    takes the wgmma kernel; f32, a K or N off the multiples of 8, or a view
    off 16-byte alignment takes the SIMT kernel."""
    make, want = ROUTE_CASES[case]
    a, b = make()
    assert k6.route(a, b) == want


def test_matmul_on_cpu_takes_the_plain_version_on_either_route():
    """On CPU tensors ``matmul_fused`` is the plain version whatever the
    route would be on the card, and counts no launch of either kernel."""
    a, b, bv, res = _mm(7, 72, 64, 40)
    t = [torch.from_numpy(x).to(BF16) for x in (a, b, bv, res)]
    assert k6.route(t[0], t[1]) == "wgmma"
    k6.launches = k6.launches_wgmma = 0
    out = k6.matmul_fused(t[0], t[1], bias=t[2], residual=t[3], act="gelu")
    assert (k6.launches, k6.launches_wgmma) == (0, 0)
    assert torch.equal(out, k6.matmul_fused_plain(t[0], t[1], bias=t[2],
                                                  residual=t[3], act="gelu"))


def test_to_tensor_carries_bf16_bit_for_bit():
    x = np.asarray(jnp.asarray(np.random.default_rng(0).standard_normal(
        (3, 5)), jnp.bfloat16))
    t = to_tensor(x, "cpu")
    assert t.dtype == torch.bfloat16
    assert np.array_equal(t.view(torch.int16).numpy().view(np.uint16),
                          x.view(np.uint16))
