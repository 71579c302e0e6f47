"""The port's LM training on the CPU against the JAX package: the loss
(``softmax_xent`` with masked labels and z-loss, ``lm_loss`` and
``lm_loss_embeds`` with every gradient against ``jax.value_and_grad``),
AdamW (dense, factored and bf16 state, three updates) and
``clip_by_global_norm``, the train step with 1 and 2 microbatches, the LM
data pipelines bit for bit, and the trainer and quickstart entry points.

Params are the reference's ``init_lm`` carried across by
``params_from_jax``; the reference runs on its xla path (its Pallas kernels
have no VJP).  Tolerances: f32 loss within 1e-5 relative, each gradient
leaf within 1e-4 * max |ref grad| of that leaf, params after the optimizer
within 1e-4 * max |ref update| (f32 state) or 2e-2 (bf16 state, whose
roundings may land a bf16 step apart).

Two conditioning cases, the reference's as much as the port's.  RWKV's
bonus ``u`` is 0 at init, which makes the group norm's input 0 at the
first token and rank one at the second: both frameworks' f32 gradients
then sit about 1e-3 of max |grad| from a float64 evaluation, so the RWKV
case draws ``u`` at random (as a trained model has it).  And AdamW divides
each element by its own gradient's size: Qwen2's key bias, added before
RoPE at theta 1e6, barely moves the logits, so its gradient nearly cancels
and the default eps 1e-8 turns its rounding into updates of either sign;
the train-step test therefore runs AdamW with eps 1e-3 (the update stays
linear in a tiny gradient), while the optimizer test holds the default
eps on given gradients.
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
from repro.data import pipeline as jax_pipeline
from repro.nn import common as jax_common
from repro.nn import transformer as jax_T
from repro.optim.adamw import AdamW as JaxAdamW
from repro.optim.adamw import clip_by_global_norm as jax_clip
from repro.train import step as jax_step
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.data import pipeline
from repro_torch.launch import quickstart, train
from repro_torch.nn import common
from repro_torch.nn import transformer as T
from repro_torch.optim.adamw import (AdamW, clip_by_global_norm, tree_leaves,
                                    tree_map)
from repro_torch.train import step as step_lib

ARCHS = ["qwen2-1.5b", "qwen3-8b", "smollm-360m", "rwkv6-1.6b",
         "jamba-1.5-large-398b", "internvl2-2b"]
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
UPDATE_TOL = 1e-4
# Jamba's smoke period (8 blocks) cut to the shortest that keeps its three
# parts: a Mamba block with the MoE (the scan and the aux loss) and an
# attention block.  Its reference init and gradient compile in half the time.
JAMBA_PERIOD = (("mamba", "moe"), ("attn", "dense"))


def _cfgs(arch, **kw):
    """The same smoke config on both sides (2 layers for a one-entry
    pattern, ``JAMBA_PERIOD`` for Jamba)."""
    cfg_t, cfg_j = smoke_config(get_config(arch)), \
        jax_smoke_config(jax_get_config(arch))
    if arch.startswith("jamba"):
        kw.setdefault("block_pattern", JAMBA_PERIOD)
    if len(kw.get("block_pattern", cfg_t.block_pattern)) <= 2:
        kw.setdefault("n_layers", 2)
    return (dataclasses.replace(cfg_t, **kw),
            dataclasses.replace(cfg_j, **kw))


@functools.lru_cache(maxsize=None)
def _reference_params(cfg_j, seed):
    """``init_lm``'s params, jitted (eagerly it compiles each op)."""
    return jax.jit(lambda key: jax_T.init_lm(key, cfg_j)[0])(
        jax.random.PRNGKey(seed))


def _model(arch, seed=0, **kw):
    """Both configs, the reference's params (jitted init, memoised) and a
    fresh copy of them as the port's tensors."""
    cfg_t, cfg_j = _cfgs(arch, **kw)
    jp = jax.tree.map(lambda x: x, _reference_params(cfg_j, seed))
    for pos, (mixer, _) in enumerate(cfg_j.block_pattern):
        if mixer == "rwkv":                  # the bonus, drawn (docstring)
            blk = jp["blocks"][str(pos)]["mixer"]
            blk["u"] = jnp.asarray(np.random.default_rng(seed).uniform(
                0.5, 1.5, blk["u"].shape), blk["u"].dtype)
    return cfg_t, cfg_j, jp, params_from_jax(jp, "cpu")


def _rel(out, exp) -> float:
    out = out.detach().float().numpy() if isinstance(out, torch.Tensor) \
        else np.asarray(out, np.float32)
    exp = np.asarray(exp, np.float32)
    return float(np.abs(out - exp).max() / max(np.abs(exp).max(), 1e-30))


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict tree."""
    if isinstance(tree, dict):
        out = {}
        for key, v in tree.items():
            out.update(_flat(v, f"{prefix}/{key}"))
        return out
    return {prefix: tree}


def _batch(cfg, seed, b=2, l=12, embeds=False):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, l))
    labels = rng.integers(0, cfg.vocab, (b, l))
    labels[:, :2] = -1                       # masked positions
    out = {"labels": labels}
    if embeds:
        out["embeds"] = (rng.standard_normal((b, l, cfg.d_model)) * 0.3
                         ).astype(np.float32)
    else:
        out["tokens"] = toks
    return out


@pytest.mark.parametrize("z_loss", [0.0, 1e-3])
def test_softmax_xent_matches_reference(z_loss):
    rng = np.random.default_rng(0)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7))
    labels[0, :3] = -1
    labels[2, 5] = -1
    exp = jax_common.softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                  z_loss=z_loss)
    out = common.softmax_xent(torch.from_numpy(logits),
                              torch.from_numpy(labels), z_loss=z_loss)
    assert abs(float(out) - float(exp)) <= LOSS_TOL * abs(float(exp))
    none = common.softmax_xent(torch.from_numpy(logits),
                               torch.full((3, 7), -1))
    assert float(none) == 0.0


def _grads(params, fn):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss = fn(params)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(leaves, grads))
    return loss.detach(), tree_map(lambda _: next(it), params)


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_gradients_match_reference(arch):
    """``lm_loss`` (``lm_loss_embeds`` for the VLM) and the gradient of
    every leaf against ``jax.value_and_grad`` of the reference's; Jamba
    brings the MoE aux loss and the Mamba scan, Qwen3 the qk-norm."""
    cfg_t, cfg_j, jp, tp = _model(arch)
    embeds = cfg_t.frontend == "vision"
    batch = _batch(cfg_t, 1, embeds=embeds)
    fn = jax_T.lm_loss_embeds if embeds else jax_T.lm_loss
    exp, g_e = jax.jit(jax.value_and_grad(fn), static_argnums=(1,),
                       static_argnames=("impl",))(
        jp, cfg_j, jnp.asarray(batch["embeds" if embeds else "tokens"]),
        jnp.asarray(batch["labels"]), impl="xla")
    tb = step_lib.lm_batch(batch, "cpu")
    loss, g = _grads(tp, lambda p: step_lib.loss_for_batch(p, cfg_t, tb))
    assert abs(float(loss) - float(exp)) <= LOSS_TOL * abs(float(exp))
    g_e, g = _flat(g_e), _flat(g)
    assert set(g) == set(g_e)
    if embeds:                               # the token table is unused
        assert not np.asarray(g_e["/embed"]).any()
    for name, leaf in g.items():
        assert _rel(leaf, g_e[name]) <= GRAD_TOL, (name, _rel(leaf,
                                                               g_e[name]))


def _leaves_like(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda x: jnp.asarray(
        rng.standard_normal(x.shape) * 0.1, x.dtype), tree)


@pytest.mark.parametrize("variant", ["dense", "factored", "bf16_state"])
def test_adamw_three_updates_match_reference(variant):
    kw = {"dense": {}, "factored": dict(factored=True, factored_min_size=8),
          "bf16_state": dict(state_dtype=jnp.bfloat16)}[variant]
    tkw = dict(kw, state_dtype=torch.bfloat16) if variant == "bf16_state" \
        else kw
    opt_j, opt_t = JaxAdamW(**kw), AdamW(**tkw)
    _, _, jp, _ = _model("qwen2-1.5b")
    state_j = opt_j.init(jp)
    update_j = jax.jit(opt_j.update)
    tp = params_from_jax(jp, "cpu")
    state_t = params_from_jax(state_j, "cpu")
    assert tree_map(lambda a, b: (a.shape, a.dtype) == (b.shape,
                                                              b.dtype),
                          opt_t.init(tp)["mu"], state_t["mu"])
    p0 = _flat(jp)
    for i in range(3):
        grads = _leaves_like(jp, 10 + i)
        jp, state_j = update_j(grads, state_j, jp, 1e-2)
        tp, state_t = opt_t.update(params_from_jax(grads, "cpu"), state_t,
                                   tp, 1e-2)
    assert int(state_t["count"]) == int(state_j["count"]) == 3
    tol = 2e-2 if variant == "bf16_state" else UPDATE_TOL
    for name, leaf in _flat(tp).items():
        upd = np.asarray(_flat(jp)[name]) - np.asarray(p0[name])
        diff = leaf.numpy() - np.asarray(_flat(jp)[name])
        assert np.abs(diff).max() <= tol * np.abs(upd).max(), name
    for name, slot in _flat(state_t["mu"]).items():
        assert _rel(slot, _flat(state_j["mu"])[name]) <= tol, name


def test_clip_by_global_norm_matches_reference():
    _, _, jp, _ = _model("smollm-360m")
    grads = _leaves_like(jp, 6)
    for max_norm in (0.5, 1e4):
        exp, gn_e = jax_clip(grads, max_norm)
        out, gn = clip_by_global_norm(params_from_jax(grads, "cpu"),
                                            max_norm)
        assert abs(float(gn) - float(gn_e)) <= 1e-6 * float(gn_e)
        for name, leaf in _flat(out).items():
            assert _rel(leaf, _flat(exp)[name]) <= 1e-6


@pytest.mark.parametrize("accum_steps", [1, 2])
def test_train_step_matches_reference(accum_steps):
    """Loss, gradient norm and params after one step (clip 1.0, lr 1e-2,
    AdamW eps 1e-3: the docstring) with 1 and 2 microbatches."""
    cfg_t, cfg_j, jp, tp = _model("qwen2-1.5b")
    opt_j, opt_t = JaxAdamW(eps=1e-3), AdamW(eps=1e-3)
    state_j = {"params": jp, "opt": opt_j.init(jp),
               "step": jnp.zeros((), jnp.int32)}
    state_t = {"params": tp, "opt": params_from_jax(state_j["opt"], "cpu"),
               "step": torch.zeros((), dtype=torch.int32)}
    batch = _batch(cfg_t, 8, b=4, l=10)
    step_j = jax_step.make_train_step(cfg_j, opt_j, lr=1e-2, clip=1.0,
                                      accum_steps=accum_steps, impl="xla")
    step_t = step_lib.make_train_step(cfg_t, opt_t, lr=1e-2, clip=1.0,
                                      accum_steps=accum_steps)
    new_j, m_j = jax.jit(step_j)(state_j, {k: jnp.asarray(v)
                                  for k, v in batch.items()})
    new_t, m_t = step_t(state_t, batch)
    assert int(new_t["step"]) == 1
    assert abs(float(m_t["loss"]) - float(m_j["loss"])) \
        <= LOSS_TOL * float(m_j["loss"])
    assert abs(float(m_t["grad_norm"]) - float(m_j["grad_norm"])) \
        <= 1e-4 * float(m_j["grad_norm"])
    p0 = _flat(jp)
    for name, leaf in _flat(new_t["params"]).items():
        exp = np.asarray(_flat(new_j["params"])[name])
        upd = np.abs(exp - np.asarray(p0[name])).max()
        assert np.abs(leaf.detach().numpy() - exp).max() \
            <= UPDATE_TOL * upd, name


class _FunctionalSgd:
    """p - lr g as new tensors, the reference's functional contract: the
    step must take the params ``update`` returns, not rely on writes in
    place."""

    def init(self, params):
        return {"count": 0}

    def update(self, grads, state, params, lr):
        with torch.no_grad():
            new = tree_map(lambda g, p: p - lr * g, grads, params)
        return new, {"count": state["count"] + 1}


def test_train_step_takes_what_the_optimizer_returns():
    cfg_t, _, _, tp = _model("smollm-360m")
    before = {name: leaf.detach().clone()
              for name, leaf in _flat(tp).items()}
    state = {"params": tp, "opt": {"count": 0},
             "step": torch.zeros((), dtype=torch.int32)}
    step = step_lib.make_train_step(cfg_t, _FunctionalSgd(), lr=1e-1)
    batch = _batch(cfg_t, 3)
    for _ in range(2):
        state, metrics = step(state, batch)
    assert state["opt"]["count"] == 2 and int(state["step"]) == 2
    assert all(torch.equal(leaf, before[name])          # not written in place
               for name, leaf in _flat(tp).items())
    moved = [not torch.equal(leaf.detach(), before[name])
             for name, leaf in _flat(state["params"]).items()]
    assert all(moved)


def test_train_step_raises_where_a_gradient_is_lost():
    """A param the loss does not reach (as one behind a kernel without a
    backward would be) raises; only the token table under "embeds" takes a
    zero gradient, as the reference's does."""
    cfg_t, _, _, tp = _model("smollm-360m")
    opt = AdamW()
    tp["stray"] = torch.zeros(3)
    state = {"params": tp, "opt": opt.init(tp),
             "step": torch.zeros((), dtype=torch.int32)}
    with pytest.raises(RuntimeError, match="no gradient"):
        step_lib.make_train_step(cfg_t, opt)(state, _batch(cfg_t, 4))
    cfg_v, _, _, vp = _model("internvl2-2b")
    embed = vp["embed"].detach().clone()
    state = {"params": vp, "opt": opt.init(vp),
             "step": torch.zeros((), dtype=torch.int32)}
    state, metrics = step_lib.make_train_step(cfg_v, AdamW(
        weight_decay=0.0))(state, _batch(cfg_v, 5, embeds=True))
    assert np.isfinite(float(metrics["loss"]))
    assert torch.equal(state["params"]["embed"].detach(), embed)


def test_synthetic_lm_data_is_the_reference_stream():
    for kw in (dict(vocab=256, seq_len=32, global_batch=8),
               dict(vocab=151936, seq_len=16, global_batch=4, seed=3,
                    n_shards=2, shard=1)):
        ours, ref = pipeline.SyntheticLMData(**kw), \
            jax_pipeline.SyntheticLMData(**kw)
        for step in (0, 5):
            a, b = ours.batch_at(step), ref.batch_at(step)
            assert set(a) == set(b) == {"tokens", "labels"}
            for key in a:
                assert a[key].dtype == b[key].dtype
                assert np.array_equal(a[key], b[key])


def test_token_file_data_is_the_reference_stream(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 60000, 5000).astype(
        np.uint16).tofile(path)
    cfg = smoke_config(get_config("smollm-360m"))
    ours = pipeline.make_pipeline(cfg, seq_len=16, global_batch=4,
                                  path=str(path))
    ref = jax_pipeline.make_pipeline(cfg, seq_len=16, global_batch=4,
                                     path=str(path))
    assert isinstance(ours, pipeline.TokenFileData)
    for step in (0, 7, 90):
        a, b = ours.batch_at(step), ref.batch_at(step)
        assert all(np.array_equal(a[k], b[k]) for k in ("tokens", "labels"))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_main_on_cpu(arch, capsys):
    summary = train.main(["--arch", arch, "--smoke", "--steps", "2",
                          "--seq-len", "16", "--global-batch", "4",
                          "--accum-steps", "2", "--device", "cpu"])
    assert summary["steps"] == 2 and summary["tokens_per_s"] > 0
    assert np.isfinite(summary["last"]["loss"])
    assert "tokens/s=" in capsys.readouterr().out


def test_train_refuses_the_unported_flags():
    for flag in (["--ckpt-dir", "x"], ["--production-mesh"],
                 ["--chaos-seed", "1"]):
        with pytest.raises(SystemExit):
            train.main(["--smoke", "--device", "cpu", *flag])


def test_quickstart_trains_and_generates(capsys):
    out = quickstart.main(["--device", "cpu", "--steps", "12"])
    assert out["losses"][-1] < out["losses"][0]
    assert len(out["generated"]) == 12
    assert "genout" in capsys.readouterr().out


def test_prefill_and_decode_steps():
    cfg_t, _, _, tp = _model("qwen2-1.5b")
    toks = torch.from_numpy(_batch(cfg_t, 9, l=6)["tokens"])
    last, cache = step_lib.make_prefill_step(cfg_t, cache_len=8)(
        tp, {"tokens": toks})
    full, _ = T.forward(tp, cfg_t, tokens=toks)
    assert torch.equal(last, full[:, -1:])
    nxt = last.argmax(-1)
    logits, _ = step_lib.make_decode_step(cfg_t)(tp, nxt, cache, 6)
    exp, _ = T.forward(tp, cfg_t, tokens=torch.cat([toks, nxt], dim=1))
    assert _rel(logits[:, 0], exp[:, -1].numpy()) <= 1e-4
