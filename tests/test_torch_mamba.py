"""The port's Mamba slice on the CPU against the JAX package, on the same
numpy inputs and params: K8's plain version (``conv1d_causal_plain``,
``ref.conv1d_causal``, ``ops.conv1d``) and the Mamba mixer (``apply``
with its decode states, ``decode``).

References: ``repro.kernels.ref.conv1d_causal`` (the xla path) and the
Pallas ``conv1d_causal`` in interpret mode (it uses no ``pl.unblocked``,
so it runs here); the reference's ``mamba.apply`` / ``mamba.decode`` on
``smoke_config(jamba)`` (d_inner 128, d_state 8, scan_chunk 8).

Tolerances: K8's plain version f32 rtol = atol = 1e-5 (both sum the KW f32
products in the same order), bf16 max |diff| / max |ref| <= 1e-2 (one
rounding of the f32 result on each side).  The mixer in f32: max |diff| <=
1e-4 * max |ref| (the selective scan combines its pairs in another order:
the reference's associative scan in tree order, the port's doubling
scan); bf16 2e-2 * max |ref| (bf16 intermediates rounded at other places,
as in ``tests/test_decode_parity.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.kernels import conv1d_causal as jax_k8
from repro.kernels import ref as jax_ref
from repro.nn import mamba as jax_mamba
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.kernels import conv1d_causal as k8
from repro_torch.kernels import ops, ref
from repro_torch.nn import mamba

ARCH = "jamba-1.5-large-398b"
K8_TOL = 1e-5
K8_BF16_TOL = 1e-2
F32_TOL = 1e-4
BF16_TOL = 2e-2


def _rel(out, exp) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    exp = np.asarray(exp, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - exp).max()
                 / np.abs(exp).max())


def _conv_inputs(seed, b, l, d, kw):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, l, d)).astype(np.float32),
            (rng.standard_normal((kw, d)) * kw ** -0.5).astype(np.float32),
            rng.standard_normal(d).astype(np.float32))


# -- K8's plain version ------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("act", ["silu", "none"])
@pytest.mark.parametrize("d", [8, 24, 128, 256])
@pytest.mark.parametrize("l", [1, 3, 17, 64])
def test_conv1d_plain_matches_reference_and_pallas(l, d, act, dtype):
    """B 1-2 and KW 2 or 4 vary with the case; bias on every case."""
    b, kw = 1 + l % 2, 2 if d in (8, 128) else 4
    x, w, bias = _conv_inputs(l * d, b, l, d, kw)
    jx, jw, jb = (jnp.asarray(a, dtype) for a in (x, w, bias))
    tx, tw, tb = (to_tensor(np.asarray(a), "cpu") for a in (jx, jw, jb))
    out = k8.conv1d_causal_plain(tx, tw, bias=tb, act=act)
    assert out.dtype == tx.dtype and out.shape == (b, l, d)
    for exp in (jax_ref.conv1d_causal(jx, jw, bias=jb, act=act),
                jax_k8.conv1d_causal(jx, jw, bias=jb, act=act,
                                     d_blk=min(d, 128), interpret=True)):
        if dtype == "float32":
            np.testing.assert_allclose(out.numpy(), np.asarray(exp),
                                       rtol=K8_TOL, atol=K8_TOL)
        else:
            assert _rel(out, exp) <= K8_BF16_TOL


def test_conv1d_plain_without_bias_and_on_strided_rows():
    """No bias is a zero bias; rows with a stride (the Mamba mixer's half of
    its input projection) give what their contiguous copy gives."""
    x, w, _ = _conv_inputs(3, 2, 9, 32, 4)
    exp = jax_ref.conv1d_causal(jnp.asarray(x), jnp.asarray(w), act="silu")
    wide = torch.from_numpy(np.concatenate([x, -x], axis=-1))
    half = wide.chunk(2, dim=-1)[0]
    assert not half.is_contiguous()
    out = k8.conv1d_causal_plain(half, torch.from_numpy(w))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=K8_TOL,
                               atol=K8_TOL)


def test_conv1d_ops_on_cpu_take_the_plain_version():
    x, w, bias = (torch.from_numpy(a) for a in _conv_inputs(4, 1, 12, 20, 4))
    before = k8.launches
    out = ops.conv1d(x, w, bias=bias, act="silu")
    assert k8.launches == before
    assert torch.equal(out, ref.conv1d_causal(x, w, bias=bias, act="silu"))
    assert torch.equal(out, k8.conv1d_causal(x, w, bias=bias))


def test_conv1d_rejects_bad_shapes_and_acts():
    x, w, bias = (torch.from_numpy(a) for a in _conv_inputs(5, 1, 6, 16, 4))
    with pytest.raises(ValueError, match="act"):
        k8.conv1d_causal(x, w, act="relu")
    with pytest.raises(ValueError, match="KW,D"):
        k8.conv1d_causal(x, w[:, :8])
    with pytest.raises(ValueError, match="bias"):
        k8.conv1d_causal(x, w, bias=bias[:8])
    with pytest.raises(ValueError):
        ref.conv1d_causal(x, w, act="gelu")


@pytest.mark.parametrize("b,l,d", [(1, 1, 16384), (1, 1024, 16384),
                                   (8, 512, 16384), (2, 77, 1003)])
def test_conv1d_run_length_fills_the_card(b, l, d):
    """The wrapper's run: a power of two in [8, 64] tokens, halved only
    while the grid has fewer than TARGET_BLOCKS blocks."""
    run = k8.run_length(b, l, d, 8)
    assert k8.MIN_RUN <= run <= k8.MAX_RUN and run & (run - 1) == 0
    blocks = -(-d // (8 * k8.THREADS)) * b * -(-l // run)
    if run > k8.MIN_RUN:
        assert blocks >= k8.TARGET_BLOCKS
    if run < k8.MAX_RUN:
        assert -(-d // (8 * k8.THREADS)) * b * -(-l // (2 * run)) \
            < k8.TARGET_BLOCKS


# -- the Mamba mixer ---------------------------------------------------------

def _cfgs(dtype="float32"):
    return (dataclasses.replace(smoke_config(get_config(ARCH)), dtype=dtype),
            dataclasses.replace(jax_smoke_config(jax_get_config(ARCH)),
                                dtype=dtype))


def _params(cfg_j, seed=0):
    """The reference's mixer params, with random conv and dt biases (zero
    at init, which would hide their terms)."""
    p, _ = jax_mamba.init(jax.random.PRNGKey(seed), cfg_j,
                          jnp.dtype(cfg_j.dtype))
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "dt_bias"):
        p[name] = jnp.asarray(rng.standard_normal(p[name].shape) * 0.3,
                              p[name].dtype)
    return p


def _x(seed, b, l, d, dtype="float32"):
    return jnp.asarray(np.random.default_rng(seed).standard_normal(
        (b, l, d)).astype(np.float32), dtype)


@pytest.mark.parametrize("l", [16, 13])
def test_mamba_apply_with_state_matches_reference(l):
    """L 16: two whole chunks of 8; L 13: a ragged last chunk of 5 against
    the reference's single-chunk fallback."""
    cfg_t, cfg_j = _cfgs()
    jp = _params(cfg_j)
    x = _x(l, 2, l, cfg_j.d_model)
    exp, (conv_e, ssm_e) = jax_mamba.apply(jp, cfg_j, x, return_state=True)
    out, (conv, ssm) = mamba.apply(params_from_jax(jp, "cpu"), cfg_t,
                                   to_tensor(np.asarray(x), "cpu"),
                                   return_state=True)
    assert conv.shape == (2, cfg_t.d_conv - 1, cfg_t.d_inner)
    assert ssm.shape == (2, cfg_t.d_inner, cfg_t.d_state)
    assert ssm.dtype == torch.float32
    assert _rel(out, exp) <= F32_TOL
    assert _rel(conv, conv_e) <= F32_TOL
    assert _rel(ssm, ssm_e) <= F32_TOL
    assert torch.equal(out, mamba.apply(params_from_jax(jp, "cpu"), cfg_t,
                                        to_tensor(np.asarray(x), "cpu")))


def test_mamba_apply_bf16_matches_reference():
    cfg_t, cfg_j = _cfgs("bfloat16")
    jp = _params(cfg_j, seed=1)
    x = _x(1, 2, 16, cfg_j.d_model, "bfloat16")
    exp = jax_mamba.apply(jp, cfg_j, x)
    out = mamba.apply(params_from_jax(jp, "cpu"), cfg_t,
                      to_tensor(np.asarray(x), "cpu"))
    assert out.dtype == torch.bfloat16
    assert _rel(out, exp) <= BF16_TOL


def test_mamba_decode_matches_reference():
    """Three decode steps from the states of a 13-token prefill, the new
    states written in place."""
    cfg_t, cfg_j = _cfgs()
    jp = _params(cfg_j, seed=2)
    tp = params_from_jax(jp, "cpu")
    x = _x(2, 2, 16, cfg_j.d_model)
    _, state_j = jax_mamba.apply(jp, cfg_j, x[:, :13], return_state=True)
    _, state_t = mamba.apply(tp, cfg_t, to_tensor(np.asarray(x[:, :13]),
                                                  "cpu"), return_state=True)
    for t in range(13, 16):
        exp, state_j = jax_mamba.decode(jp, cfg_j, x[:, t:t + 1], state_j)
        out, (conv, ssm) = mamba.decode(
            tp, cfg_t, to_tensor(np.asarray(x[:, t:t + 1]), "cpu"), state_t)
        assert conv is state_t[0] and ssm is state_t[1]   # in place
        assert _rel(out, exp) <= F32_TOL
        assert _rel(conv, state_j[0]) <= F32_TOL
        assert _rel(ssm, state_j[1]) <= F32_TOL


@pytest.mark.parametrize("l", [1, 2])
def test_mamba_short_prompt_state_continues_the_full_forward(l):
    """A prompt shorter than d_conv - 1 tokens: its conv state is padded
    with zeros on the left, and decoding on from it gives the port's own
    full forward (the reference cannot pack such a state)."""
    cfg_t, cfg_j = _cfgs()
    tp = params_from_jax(_params(cfg_j, seed=3), "cpu")
    x = to_tensor(np.asarray(_x(3, 2, 6, cfg_j.d_model)), "cpu")
    full = mamba.apply(tp, cfg_t, x)
    out, state = mamba.apply(tp, cfg_t, x[:, :l], return_state=True)
    assert state[0].shape == (2, cfg_t.d_conv - 1, cfg_t.d_inner)
    assert torch.equal(state[0][:, :cfg_t.d_conv - 1 - l],
                       torch.zeros_like(state[0][:, :cfg_t.d_conv - 1 - l]))
    steps = [out]
    for t in range(l, 6):
        y, state = mamba.decode(tp, cfg_t, x[:, t:t + 1], state)
        steps.append(y)
    assert _rel(torch.cat(steps, dim=1), full.numpy()) <= F32_TOL


def test_scan_pairs_is_the_sequential_recurrence():
    rng = np.random.default_rng(4)
    a = torch.from_numpy(rng.uniform(0.2, 1.0, (2, 13, 5, 3))
                         .astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 13, 5, 3))
                         .astype(np.float32))
    pa, pb = mamba._scan_pairs(a.clone(), b.clone())
    h, prod = torch.zeros_like(b[:, 0]), torch.ones_like(a[:, 0])
    for t in range(13):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        torch.testing.assert_close(pb[:, t], h, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(pa[:, t], prod, rtol=1e-5, atol=1e-6)


def test_mamba_init_shapes_and_dtypes_match_reference():
    cfg_t, cfg_j = _cfgs("bfloat16")
    jp = _params(cfg_j)
    tp = mamba.init(torch.Generator().manual_seed(0), cfg_t, torch.bfloat16,
                    "cpu")
    assert set(tp) == set(jp)
    for name, leaf in tp.items():
        assert tuple(leaf.shape) == jp[name].shape, name
        assert leaf.dtype == torch.bfloat16
    np.testing.assert_array_equal(tp["A_log"].float().numpy(),
                                  np.asarray(jp["A_log"], np.float32))
    assert mamba.dt_rank(get_config(ARCH)) == 512
