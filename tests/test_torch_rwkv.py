"""The port's RWKV-6 (Finch) on the CPU against the JAX package: the time
mix (``rwkv.apply`` with its decode state, ``rwkv.decode``), the channel
mix, and ``rwkv6-1.6b``'s smoke config through ``transformer.forward``,
``init_cache``, ``decode_step``, the checkpointed training forward and the
serving functions.

Params are the reference's (``init`` / ``init_lm``; for the modules, the
zero bonus ``u``, unit ``ln_x`` and constant mixes overwritten with random
values so that every term shows), carried across by ``params_from_jax``.
The reference runs on its xla path (RWKV has no kernel), under ``jax.jit``
as it runs in use (eagerly it compiles each op, most of this file's time).
Tolerance: f32
max |diff| <= 1e-5 * max |ref| (the recurrence sums its products in
another order); token ids equal.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.nn import mlp as jax_mlp
from repro.nn import rwkv as jax_rwkv
from repro.nn import transformer as jax_T
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.nn import mlp, rwkv
from repro_torch.nn import transformer as T

ARCH = "rwkv6-1.6b"
TOL = 1e-5
_TIME_MIX_INIT = functools.partial(jax_rwkv.init, dtype=jnp.float32)
_CHANNEL_MIX_INIT = functools.partial(jax_mlp.init_rwkv_cm, dtype=jnp.float32)


def _cfgs(**kw):
    """The smoke config on both sides, 2 layers unless ``kw`` says."""
    kw.setdefault("n_layers", 2)
    return (dataclasses.replace(smoke_config(get_config(ARCH)), **kw),
            dataclasses.replace(jax_smoke_config(jax_get_config(ARCH)),
                                **kw))


@functools.lru_cache(maxsize=None)
def _jitted(fn, cfg_j, static):
    static = dict(static)
    return jax.jit(lambda p, args, arrays: fn(p, cfg_j, *args, **arrays,
                                              **static))


def _ref(fn, p, cfg_j, *args, **kw):
    """``fn(p, cfg_j, *args, **kw)`` of the reference, jitted: ``cfg_j``
    and the keywords that are not arrays static."""
    arrays = {k: v for k, v in kw.items() if isinstance(v, jax.Array)}
    static = tuple(sorted((k, v) for k, v in kw.items() if k not in arrays))
    return _jitted(fn, cfg_j, static)(p, args, arrays)


@functools.lru_cache(maxsize=None)
def _init(fn, cfg_j):
    """The reference's ``fn(key, cfg_j)[0]`` (an init), jitted."""
    return jax.jit(lambda key: fn(key, cfg_j)[0])


def _rel(out, exp) -> float:
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    exp = np.asarray(exp, np.float32)
    return float(np.abs(out - exp).max() / np.abs(exp).max())


def _mixer(seed=0):
    """The reference's time-mix params with u, ln_x, dec_bias and the mixes
    drawn at random."""
    cfg_t, cfg_j = _cfgs()
    p = _init(_TIME_MIX_INIT, cfg_j)(jax.random.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    for name in ("u", "ln_x", "mu_r", "mu_k", "mu_v", "mu_g", "mu_w"):
        p[name] = jnp.asarray(rng.uniform(0.1, 1.0, p[name].shape),
                              jnp.float32)
    p["dec_bias"] = jnp.asarray(rng.uniform(-3.0, 0.5, p["dec_bias"].shape),
                                jnp.float32)
    return cfg_t, cfg_j, p, params_from_jax(p, "cpu")


def _x(seed, b, l, d):
    return np.random.default_rng(seed).standard_normal(
        (b, l, d)).astype(np.float32)


@pytest.mark.parametrize("l", [16, 70])
def test_time_mix_matches_reference(l):
    """Output and decode state; L 70 is one ragged chunk in the reference,
    a chunk of 64 and one of 6 here."""
    cfg_t, cfg_j, jp, tp = _mixer()
    x = _x(l, 2, l, cfg_t.d_model)
    exp, (xp_e, s_e) = _ref(jax_rwkv.apply, jp, cfg_j, jnp.asarray(x),
                            return_state=True)
    out, (xp, s) = rwkv.apply(tp, cfg_t, torch.from_numpy(x),
                              return_state=True)
    assert _rel(out, exp) <= TOL
    assert torch.equal(xp, torch.from_numpy(x[:, -1]))
    assert s.dtype == torch.float32 and _rel(s, s_e) <= TOL


def test_time_mix_decode_matches_reference_in_place():
    cfg_t, cfg_j, jp, tp = _mixer(1)
    nh = cfg_t.n_heads
    dh = cfg_t.d_model // nh
    rng = np.random.default_rng(3)
    x = _x(4, 2, 1, cfg_t.d_model)
    xp0 = rng.standard_normal((2, cfg_t.d_model)).astype(np.float32)
    s0 = rng.standard_normal((2, nh, dh, dh)).astype(np.float32)
    exp, (xp_e, s_e) = _ref(jax_rwkv.decode, jp, cfg_j, jnp.asarray(x),
                            (jnp.asarray(xp0), jnp.asarray(s0)))
    state = (torch.from_numpy(xp0.copy()), torch.from_numpy(s0.copy()))
    out, (xp, s) = rwkv.decode(tp, cfg_t, torch.from_numpy(x), state)
    assert xp is state[0] and s is state[1]
    assert _rel(out, exp) <= TOL
    assert _rel(s, s_e) <= TOL and torch.equal(xp, torch.from_numpy(x[:, 0]))


def test_channel_mix_matches_reference():
    cfg_t, cfg_j = _cfgs()
    jp = _init(_CHANNEL_MIX_INIT, cfg_j)(jax.random.PRNGKey(2))
    jp["mu_k"] = jnp.asarray(np.random.default_rng(2).uniform(
        0.1, 1.0, jp["mu_k"].shape), jnp.float32)
    x, xp = _x(5, 2, 9, cfg_t.d_model), _x(6, 2, 9, cfg_t.d_model)
    exp = _ref(jax_mlp.apply_rwkv_cm, jp, cfg_j, jnp.asarray(x),
               jnp.asarray(xp))
    out = mlp.apply_rwkv_cm(params_from_jax(jp, "cpu"), cfg_t,
                            torch.from_numpy(x), torch.from_numpy(xp))
    assert _rel(out, exp) <= TOL


def _model(seed=0, **kw):
    cfg_t, cfg_j = _cfgs(**kw)
    jp = _init(jax_T.init_lm, cfg_j)(jax.random.PRNGKey(seed))
    return cfg_t, cfg_j, jp, params_from_jax(jp, "cpu")


def _tokens(seed, b, l, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, l))


@pytest.mark.parametrize("l", [12, 67])
def test_forward_and_cache_match_reference(l):
    cfg_t, cfg_j, jp, tp = _model()
    toks = _tokens(l, 2, l, cfg_t.vocab)
    exp, _, cache_e = _ref(jax_T.forward, jp, cfg_j,
                           tokens=jnp.asarray(toks), impl="xla",
                           return_cache=True, cache_len=l + 4)
    out, aux, cache = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks),
                                return_cache=True, cache_len=l + 4)
    assert _rel(out, exp) <= TOL and float(aux) == 0.0
    assert set(cache["0"]) == {"x_prev", "s", "cm_x_prev"}
    for name, t in cache["0"].items():
        assert tuple(t.shape) == cache_e["0"][name].shape
        assert _rel(t, cache_e["0"][name]) <= TOL, name


def test_init_cache_layout():
    cfg_t, cfg_j = _cfgs(n_layers=3)
    cache = T.init_cache(cfg_t, 5, 32, device="cpu")
    ref = jax_T.init_cache(cfg_j, 5, 32)
    assert set(cache) == set(ref) == {"0"}
    for name, t in cache["0"].items():
        assert tuple(t.shape) == ref["0"][name].shape
        assert str(t.dtype).removeprefix("torch.") == str(
            ref["0"][name].dtype)


def test_prefill_then_decode_matches_forward():
    """Prefill 6 tokens, decode the next 5 teacher-forced: each step's
    logits against the reference's forward at that position, and the
    states written in place into the cache."""
    cfg_t, cfg_j, jp, tp = _model(1)
    toks = _tokens(9, 2, 11, cfg_t.vocab)
    exp, _ = _ref(jax_T.forward, jp, cfg_j, tokens=jnp.asarray(toks),
                  impl="xla")
    exp = np.asarray(exp)
    _, _, cache = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks[:, :6]),
                            return_cache=True, cache_len=16)
    s_before = cache["0"]["s"].clone()
    for t in range(6, 11):
        logits, out = T.decode_step(tp, cfg_t,
                                    torch.from_numpy(toks[:, t:t + 1]), cache,
                                    t)
        assert out is cache
        assert _rel(logits[:, 0], exp[:, t]) <= TOL, t
    assert not torch.equal(s_before, cache["0"]["s"])


def test_decode_step_matches_reference_decode():
    cfg_t, cfg_j, jp, tp = _model(2)
    toks = _tokens(3, 2, 8, cfg_t.vocab)
    _, _, cache_e = _ref(jax_T.forward, jp, cfg_j, tokens=jnp.asarray(toks),
                         impl="xla", return_cache=True)
    exp, _ = _ref(jax_T.decode_step, jp, cfg_j, jnp.asarray(toks[:, -1:]),
                  cache_e, 8)
    _, _, cache = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks),
                            return_cache=True)
    out, _ = T.decode_step(tp, cfg_t, torch.from_numpy(toks[:, -1:]), cache,
                           8)
    assert _rel(out, exp) <= TOL


def test_remat_forward_gives_the_same_gradients():
    """``cfg.remat`` checkpoints each repeat (and the WKV chunks always
    where autograd records): the loss and every gradient equal the
    un-checkpointed ones."""
    cfg_t, _, _, tp = _model(4, n_layers=2)
    toks = torch.from_numpy(_tokens(4, 2, 70, cfg_t.vocab))
    labels = torch.roll(toks, -1, dims=1)
    grads = []
    for remat in (False, True):
        params = {k: v for k, v in tp.items()}
        leaves = []

        def req(node):
            if isinstance(node, dict):
                return {k: req(v) for k, v in node.items()}
            leaf = node.clone().requires_grad_()
            leaves.append(leaf)
            return leaf
        params = req(params)
        loss = T.lm_loss(params, dataclasses.replace(cfg_t, remat=remat),
                         toks, labels)
        loss.backward()
        grads.append((loss.item(), [t.grad for t in leaves]))
    assert grads[0][0] == grads[1][0]
    for a, b in zip(grads[0][1], grads[1][1]):
        assert torch.equal(a, b)


def test_serve_continuous_matches_generate():
    """Greedy ids of ``serve_continuous`` (lanes refilled by batch-1
    prefills whose states are copied into the lane's cache slot) equal
    ``generate``'s and the reference's on prompts of one length (RWKV has
    no mask, so left padding would change the state)."""
    cfg_t, cfg_j, jp, tp = _model(3)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(1, cfg_t.vocab, 7) for _ in range(5)]
    exp = jax_serve.generate(jp, cfg_j, prompts, max_new=6, max_len=16)
    out = serve.generate(tp, cfg_t, prompts, max_new=6, max_len=16)
    assert out == [list(map(int, e)) for e in exp]
    cont = serve.serve_continuous(tp, cfg_t, prompts, lanes=2, max_len=16,
                                  max_new=6, eos=-1)
    assert [cont[i] for i in range(len(prompts))] == out
