"""The port's dense LM (``repro_torch.nn``) on the CPU against the JAX
package on the same params and tokens: the bf16 leaf conversion, RMS norm
and RoPE, attention prefill and decode (scalar and per-lane positions),
the SwiGLU MLP, and the whole decoder (``forward``, its KV cache, and
``decode_step`` teacher-forced) on 2-layer smoke configs of the four dense
archs.

Params are the reference's (``init_lm`` or module ``init`` with random
values written over the zero biases and unit norms), carried across by
``params_from_jax``.  The reference's forward runs on its xla path and on
its interpret path, whose attention is the Pallas K7.  Tolerances: f32
max |diff| <= 1e-4 * max |ref|; bf16 2e-2 * max |ref| (the two frameworks
round bf16 intermediates at other places, as in
``tests/test_decode_parity.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.nn import attention as jax_attention
from repro.nn import common as jax_common
from repro.nn import mlp as jax_mlp
from repro.nn import transformer as jax_T
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.nn import attention, common, mlp
from repro_torch.nn import transformer as T

DENSE = ["qwen2-1.5b", "qwen3-8b", "internlm2-1.8b", "smollm-360m"]
F32_TOL = 1e-4
BF16_TOL = 2e-2


def _cfgs(arch, **kw):
    """The same 2-layer smoke config on both sides."""
    return (dataclasses.replace(smoke_config(get_config(arch)), n_layers=2,
                                **kw),
            dataclasses.replace(jax_smoke_config(jax_get_config(arch)),
                                n_layers=2, **kw))


def _rel(out, ref) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - ref).max()
                 / np.abs(ref).max())


def _randomized(tree, seed):
    """The reference's tree with every leaf replaced by random values of
    its shape and dtype (zero biases and unit norms would hide terms)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape) * 0.3, x.dtype), tree)


def test_params_cross_bit_for_bit():
    cfg_t, cfg_j = _cfgs("qwen2-1.5b", dtype="bfloat16")
    jp, _ = jax_T.init_lm(jax.random.PRNGKey(0), cfg_j)
    tp = params_from_jax(jp, "cpu")
    assert tp["blocks"]["0"]["mixer"]["wq"].shape == (2, 64, 64)
    for (path, leaf), t in zip(jax.tree_util.tree_leaves_with_path(jp),
                               jax.tree_util.tree_leaves(tp)):
        arr = np.asarray(leaf)
        assert str(t.dtype) == f"torch.{arr.dtype.name}", path
        bits = t.view(torch.int16) if t.dtype == torch.bfloat16 else t
        assert np.array_equal(bits.numpy().view(arr.dtype), arr), path
    f32 = params_from_jax({"w": np.arange(6, dtype=np.float32)}, "cpu")
    assert f32["w"].dtype == torch.float32
    assert np.array_equal(f32["w"].numpy(), np.arange(6, dtype=np.float32))


def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32)
    pos = rng.integers(0, 2048, (2, 1, 5))
    np.testing.assert_allclose(
        common.rms_norm(torch.from_numpy(x), torch.from_numpy(scale),
                        eps=1e-5).numpy(),
        np.asarray(jax_common.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                                       eps=1e-5)), rtol=1e-5, atol=1e-5)
    for theta in (1e4, 1e6):
        out = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                theta=theta)
        exp = jax_common.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                    theta=theta)
        np.testing.assert_allclose(out.numpy(), np.asarray(exp), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "qwen3-8b"])
def test_attention_apply_and_decode_match_jax(arch):
    """qwen2 carries the QKV bias, qwen3 the qk-norm."""
    cfg_t, cfg_j = _cfgs(arch)
    jp = _randomized(jax_attention.init(jax.random.PRNGKey(1), cfg_j,
                                        jnp.float32)[0], 1)
    tp = params_from_jax(jp, "cpu")
    rng = np.random.default_rng(2)
    b, l, s = 2, 7, 12
    x = rng.standard_normal((b, l, cfg_t.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(l), (b, l)).copy()
    out, (k, v) = attention.apply(tp, cfg_t, torch.from_numpy(x),
                                  torch.from_numpy(pos), return_kv=True)
    jout, (jk, jv) = jax_attention.apply(jp, cfg_j, jnp.asarray(x),
                                         jnp.asarray(pos), impl="xla",
                                         return_kv=True)
    for got, exp in ((out, jout), (k, jk), (v, jv)):
        assert _rel(got, exp) <= F32_TOL

    # decode one token against a cache holding the prefill's K/V
    xt = rng.standard_normal((b, 1, cfg_t.d_model)).astype(np.float32)
    ck = np.zeros((b, cfg_t.n_kv_heads, s, cfg_t.head_dim), np.float32)
    cv = np.zeros_like(ck)
    ck[:, :, :l], cv[:, :, :l] = np.asarray(jk), np.asarray(jv)
    for idx in (l, np.array([l, 3])):     # lockstep, then per lane
        t_idx = torch.as_tensor(idx)
        tk, tv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
        o, (nk, nv) = attention.decode(tp, cfg_t, torch.from_numpy(xt),
                                       (tk, tv), t_idx)
        assert nk is tk and nv is tv      # written in place
        jo, (jnk, jnv) = jax_attention.decode(
            jp, cfg_j, jnp.asarray(xt), (jnp.asarray(ck), jnp.asarray(cv)),
            jnp.asarray(idx, jnp.int32))
        assert _rel(o, jo) <= F32_TOL
        assert _rel(nk, jnk) <= F32_TOL and _rel(nv, jnv) <= F32_TOL


def test_mlp_matches_jax():
    cfg_t, cfg_j = _cfgs("qwen2-1.5b")
    jp = _randomized(jax_mlp.init(jax.random.PRNGKey(3), cfg_j,
                                  jnp.float32)[0], 3)
    x = np.random.default_rng(4).standard_normal(
        (2, 5, cfg_t.d_model)).astype(np.float32)
    out = mlp.apply(params_from_jax(jp, "cpu"), cfg_t, torch.from_numpy(x))
    assert _rel(out, jax_mlp.apply(jp, cfg_j, jnp.asarray(x))) <= F32_TOL


def _model(arch, seed=0, **kw):
    cfg_t, cfg_j = _cfgs(arch, **kw)
    jp, _ = jax_T.init_lm(jax.random.PRNGKey(seed), cfg_j)
    if cfg_j.dtype == "float32":
        jp = _randomized(jp, seed)
    return cfg_t, cfg_j, jp, params_from_jax(jp, "cpu")


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch, impl):
    cfg_t, cfg_j, jp, tp = _model(arch)
    toks = np.random.default_rng(5).integers(0, cfg_t.vocab, (2, 16))
    logits, aux = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks))
    jlogits, _ = jax_T.forward(jp, cfg_j, tokens=jnp.asarray(toks),
                               impl=impl)
    assert logits.shape == (2, 16, cfg_t.vocab) and float(aux) == 0.0
    assert _rel(logits, jlogits) <= F32_TOL


@pytest.mark.parametrize("arch", DENSE)
def test_cache_and_decode_steps_match_jax(arch):
    """``forward(return_cache=True)`` gives the reference's cache; then 6
    teacher-forced decode steps give its logits."""
    cfg_t, cfg_j, jp, tp = _model(arch, seed=1)
    toks = np.random.default_rng(6).integers(0, cfg_t.vocab, (2, 14))
    lp, steps, cache_len = 8, 6, 16
    prompt = toks[:, :lp]
    logits, _, cache = T.forward(tp, cfg_t, tokens=torch.from_numpy(prompt),
                                 return_cache=True, cache_len=cache_len)
    jlogits, _, jcache = jax_T.forward(jp, cfg_j, tokens=jnp.asarray(prompt),
                                       impl="xla", return_cache=True,
                                       cache_len=cache_len)
    assert _rel(logits, jlogits) <= F32_TOL
    for name in ("k", "v"):
        assert cache["0"][name].shape == jcache["0"][name].shape
        assert _rel(cache["0"][name], jcache["0"][name]) <= F32_TOL
    for t in range(steps):
        tok = toks[:, lp + t:lp + t + 1]
        out, cache = T.decode_step(tp, cfg_t, torch.from_numpy(tok), cache,
                                   lp + t)
        jout, jcache = jax_T.decode_step(jp, cfg_j, jnp.asarray(tok), jcache,
                                         jnp.int32(lp + t))
        assert out.shape == (2, 1, cfg_t.vocab)
        assert _rel(out, jout) <= F32_TOL, t
    for name in ("k", "v"):
        assert _rel(cache["0"][name], jcache["0"][name]) <= F32_TOL


def test_decode_from_empty_cache_matches_forward():
    """Token-by-token decode from ``init_cache`` reproduces the prefill
    logits (the port against itself, as ``test_decode_parity.py`` holds the
    reference)."""
    cfg_t, _, _, tp = _model("smollm-360m", seed=2)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg_t.vocab, (2, 6)))
    full, _ = T.forward(tp, cfg_t, tokens=toks)
    cache = T.init_cache(cfg_t, 2, 6, device="cpu")
    outs = []
    for t in range(6):
        out, cache = T.decode_step(tp, cfg_t, toks[:, t:t + 1], cache, t)
        outs.append(out)
    assert _rel(torch.cat(outs, dim=1), full.numpy()) <= F32_TOL


def test_forward_bf16_matches_jax():
    cfg_t, cfg_j, jp, tp = _model("qwen2-1.5b", dtype="bfloat16")
    assert tp["embed"].dtype == torch.bfloat16
    toks = np.random.default_rng(8).integers(0, cfg_t.vocab, (2, 12))
    logits, _ = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks))
    jlogits, _ = jax_T.forward(jp, cfg_j, tokens=jnp.asarray(toks),
                               impl="xla")
    assert logits.dtype == torch.bfloat16
    assert _rel(logits, jlogits) <= BF16_TOL


def test_init_lm_layout_and_dtype():
    cfg = dataclasses.replace(smoke_config(get_config("internlm2-1.8b")),
                              n_layers=3, dtype="bfloat16")
    p = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert p["head"].shape == (cfg.d_model, cfg.vocab)
    blk = p["blocks"]["0"]
    assert blk["mixer"]["wk"].shape == (3, cfg.d_model,
                                        cfg.n_kv_heads * cfg.head_dim)
    assert blk["mlp"]["w_down"].shape == (3, cfg.d_ff, cfg.d_model)
    assert all(t.dtype == torch.bfloat16
               for t in jax.tree_util.tree_leaves(p))
    again = T.init_lm(cfg, torch.Generator().manual_seed(0), device="cpu")
    assert torch.equal(p["embed"], again["embed"])
