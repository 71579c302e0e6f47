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


def _qkv_bf16(b, hq, hkv, l, dh):
    return [torch.zeros(shape, dtype=BF16)
            for shape in ((b, hq, l, dh), (b, hkv, l, dh), (b, hkv, l, dh))]


def _offset_qkv(b, hq, hkv, l, dh):
    """q a contiguous view 2 bytes past a fresh allocation: off TMA's
    16-byte alignment."""
    q, k, v = _qkv_bf16(b, hq, hkv, l, dh)
    n = q.numel()
    return torch.zeros(n + 1, dtype=BF16)[1:].view(q.shape), k, v


def _strided_qkv(b, hq, hkv, l, dh):
    """k a (B, Hkv, L, Dh) view of a (B, L, Hkv, Dh) tensor: the layout of a
    projection before its transpose, not contiguous."""
    q, _, v = _qkv_bf16(b, hq, hkv, l, dh)
    return q, torch.zeros((b, l, hkv, dh), dtype=BF16).transpose(1, 2), v


# (q, k, v) of each case and the route a CUDA call of flash_attention takes
ATTN_ROUTE_CASES = {
    "bf16 Dh 128": (lambda: _qkv_bf16(1, 12, 2, 70, 128), "wgmma"),
    "bf16 Dh 64": (lambda: _qkv_bf16(2, 15, 5, 33, 64), "wgmma"),
    "bf16 Dh 16": (lambda: _qkv_bf16(1, 4, 2, 37, 16), "simt"),
    "f32 Dh 128": (lambda: _t(_qkv(1, 1, 4, 2, 70, 128)), "simt"),
    "f32 Dh 64": (lambda: _t(_qkv(1, 1, 4, 4, 9, 64)), "simt"),
    "offset q": (lambda: _offset_qkv(1, 4, 2, 40, 128), "simt"),
    "non-contiguous k": (lambda: _strided_qkv(1, 4, 2, 40, 64), "simt"),
}


@pytest.mark.parametrize("case", list(ATTN_ROUTE_CASES))
def test_attention_route_by_dtype_head_width_and_alignment(case):
    """``attention.route``: bf16 q, k, v with Dh 64 or 128, contiguous and
    16-byte aligned take the wgmma kernel; f32 at any Dh, bf16 at Dh 16, an
    unaligned view or a non-contiguous tensor take the SIMT kernel."""
    make, want = ATTN_ROUTE_CASES[case]
    assert k7.route(*make()) == want


@pytest.mark.parametrize("b,hq,l,causal,kb", [
    (1, 12, 1024, True, 128), (1, 15, 512, True, 128), (1, 12, 333, True, 64),
    (1, 12, 1024, False, 64), (8, 12, 512, True, 64), (8, 12, 128, True, 64),
    (1, 64, 1024, True, 64), (2, 12, 700, True, 128)])
def test_attention_key_block_by_shape(b, hq, l, causal, kb):
    """``wgmma_key_block``: 128 keys a step only for a causal prompt of 512
    tokens or more whose 64-query blocks fit twice on the card's SMs."""
    assert k7.wgmma_key_block(b, hq, l, causal) == kb


def wgmma_emulated(q, k, v, *, causal, scale=None, p_dtype=BF16,
                   out_dtype=BF16):
    """K7's wgmma route in plain torch, rounding where it rounds: S = Q Kᵀ
    in f32 from the bf16 q and k, scaled after the product (log2 e folded
    in); per 64-key block the running max, p = 2^(s - m) in f32 (masked
    logits 0), l summed from the f32 p, P rounded to ``p_dtype`` (bf16) for
    P V with f32 accumulation; out = acc / l rounded to ``out_dtype``."""
    b, hq, l, dh = q.shape
    rep = hq // k.shape[1]
    kf = k.float().repeat_interleave(rep, dim=1)
    vf = v.float().repeat_interleave(rep, dim=1)
    qf = q.float()
    c = torch.tensor((dh ** -0.5 if scale is None else scale)
                     * 1.4426950408889634, dtype=torch.float32)
    m = torch.full((b, hq, l), -1e30)
    lsum = torch.zeros((b, hq, l))
    acc = torch.zeros((b, hq, l, dh))
    rows = torch.arange(l)
    for k0 in range(0, l, 64):
        keys = torch.arange(k0, min(k0 + 64, l))
        s = (qf @ kf[:, :, k0:k0 + 64].transpose(-1, -2)) * c
        if causal:
            s = s.masked_fill(keys[None, :] > rows[:, None], float("-inf"))
        mx = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - mx)
        m = mx
        p = torch.exp2(s - m[..., None])
        lsum = lsum * alpha + p.sum(-1)
        acc = acc * alpha[..., None] \
            + p.to(p_dtype).float() @ vf[:, :, k0:k0 + 64]
    return (acc / lsum[..., None]).to(out_dtype)


def _row_rel(out, exp) -> float:
    """The worst query row's max |diff| / max |exp|."""
    out, exp = out.float(), exp.float()
    return float(((out - exp).abs().amax(-1)
                  / exp.abs().amax(-1).clamp_min(1e-30)).max())


@pytest.mark.parametrize("l", [333, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_wgmma_roundings_hold_the_bf16_row_limit(l, causal):
    """The wgmma route's roundings against ``flash_attention_plain`` at
    Qwen2-1.5B's heads (GQA 12/2, Dh 128): within the bf16 limit of 1e-2 of
    max |plain| per query row, before the card runs it.  Prints the
    headroom, and the share of P's rounding (the new one): the emulation
    in f32 out against the plain version on the same values in f32.  That
    share stays under 2^-8, the least step of a bf16 output relative to its
    row's max, so the two bf16 outputs differ by at most 2^-7 of it."""
    q, k, v = _t(_qkv(l, 1, 12, 2, l, 128), BF16)
    out = wgmma_emulated(q, k, v, causal=causal)
    err = _row_rel(out, k7.flash_attention_plain(q, k, v, causal=causal))
    p_only = _row_rel(
        wgmma_emulated(q, k, v, causal=causal, out_dtype=torch.float32),
        k7.flash_attention_plain(q.float(), k.float(), v.float(),
                                 causal=causal))
    print(f"L {l} causal {causal}: worst row {err:.3e} of the 1e-2 limit "
          f"(headroom {BF16_REL_TOL / err:.2f}x); P's rounding alone "
          f"{p_only:.3e}, the rest one bf16 step of the output")
    assert err <= BF16_REL_TOL
    assert p_only < 2.0 ** -8


def test_wgmma_emulation_is_the_plain_function_in_f32():
    """Without the bf16 roundings (P and the output in f32) the emulated
    blockwise order equals the plain version within f32's 1e-5: the
    emulation is the same function, so its bf16 gap is the roundings'."""
    q, k, v = _t(_qkv(3, 1, 6, 2, 150, 64))
    out = wgmma_emulated(q, k, v, causal=True, p_dtype=torch.float32,
                         out_dtype=torch.float32)
    _close(out, k7.flash_attention_plain(q, k, v, causal=True).numpy())


def test_flash_on_cpu_takes_the_plain_version_on_either_route():
    """On CPU tensors ``flash_attention`` is the plain version whatever the
    route would be on the card, and counts no launch of either kernel."""
    q, k, v = _t(_qkv(8, 1, 4, 2, 70, 128), BF16)
    assert k7.route(q, k, v) == "wgmma"
    k7.launches = k7.launches_wgmma = 0
    out = k7.flash_attention(q, k, v, causal=True)
    assert (k7.launches, k7.launches_wgmma) == (0, 0)
    assert torch.equal(out, k7.flash_attention_plain(q, k, v, causal=True))


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
