"""The port's hybrid decoder on the CPU against the JAX package: the Jamba
pattern (7 Mamba + 1 attention mixer per 8-layer period, MoE on the odd
positions) and Phi-3.5-MoE's ("attn", "moe") pattern through
``transformer.forward``, ``init_cache``, ``decode_step`` and the serving
functions, on the reference's ``init_lm`` params carried across by
``params_from_jax``; and the served config's cut.

The reference runs on its xla path, and for ``forward`` also on its
interpret path (the Pallas K8 and K7).  Tolerances: f32 max |diff| <=
1e-4 * max |ref| (the selective scan and the MoE einsums sum in other
orders); bf16 2e-2 * max |ref| (bf16 intermediates rounded at other
places, as in ``tests/test_decode_parity.py``); token ids equal.
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import smoke_config as jax_smoke_config
from repro.launch import serve as jax_serve
from repro.nn import transformer as jax_T
from repro_torch.configs import get_config, smoke_config
from repro_torch.convert import params_from_jax, take_expert_share
from repro_torch.kernels import conv1d_causal as k8
from repro_torch.launch import serve
from repro_torch.nn import transformer as T

ROOT = pathlib.Path(__file__).resolve().parents[1]
HYBRID = ["jamba-1.5-large-398b", "phi3.5-moe-42b-a6.6b"]
F32_TOL = 1e-4
BF16_TOL = 2e-2


def _cfgs(arch, dtype="float32", capacity_factor=None):
    """The same smoke config on both sides (Jamba: one 8-layer period;
    Phi-3.5-MoE: one layer), optionally dropless."""
    out = []
    for cfg in (smoke_config(get_config(arch)),
                jax_smoke_config(jax_get_config(arch))):
        cfg = dataclasses.replace(cfg, dtype=dtype)
        if capacity_factor is not None:
            cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
                cfg.moe, capacity_factor=capacity_factor))
        out.append(cfg)
    return out


def _model(arch, seed=0, **kw):
    cfg_t, cfg_j = _cfgs(arch, **kw)
    jp, _ = jax_T.init_lm(jax.random.PRNGKey(seed), cfg_j)
    return cfg_t, cfg_j, jp, params_from_jax(jp, "cpu")


def _rel(out, exp) -> float:
    out = out.float().numpy() if isinstance(out, torch.Tensor) else out
    exp = np.asarray(exp, np.float32)
    return float(np.abs(np.asarray(out, np.float32) - exp).max()
                 / np.abs(exp).max())


def _tokens(seed, b, l, vocab):
    return np.random.default_rng(seed).integers(0, vocab, (b, l))


@pytest.mark.parametrize("impl", ["xla", "interpret"])
@pytest.mark.parametrize("l", [16, 13])
@pytest.mark.parametrize("arch", HYBRID)
def test_forward_matches_reference(arch, l, impl):
    """Logits and the MoE aux loss; L 13 gives the scan a ragged chunk."""
    cfg_t, cfg_j, jp, tp = _model(arch)
    toks = _tokens(l, 2, l, cfg_t.vocab)
    exp, aux_e = jax_T.forward(jp, cfg_j, tokens=jnp.asarray(toks),
                               impl=impl)
    out, aux = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks))
    assert out.shape == (2, l, cfg_t.vocab)
    assert _rel(out, exp) <= F32_TOL
    np.testing.assert_allclose(float(aux), float(aux_e), rtol=1e-4)
    assert float(aux) > 0


def test_forward_bf16_matches_reference():
    """Phi-3.5-MoE's one-layer smoke model, whole, in bf16."""
    cfg_t, cfg_j, jp, tp = _model("phi3.5-moe-42b-a6.6b", dtype="bfloat16",
                                  seed=1)
    toks = _tokens(1, 2, 16, cfg_t.vocab)
    exp, _ = jax_T.forward(jp, cfg_j, tokens=jnp.asarray(toks))
    out, _ = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks))
    assert out.dtype == torch.bfloat16
    assert _rel(out, exp) <= BF16_TOL


@pytest.mark.parametrize("pos", range(8))
def test_jamba_blocks_bf16_match_reference(pos):
    """Each of the 8 layer kinds of the Jamba period in bf16, on the same
    input.  The whole 8-layer bf16 model is not compared: with random
    weights a bf16 rounding difference can change a token's second expert,
    which moves its output by as much as the output itself, and from there
    the rest of the stack."""
    cfg_t, cfg_j, jp, tp = _model("jamba-1.5-large-398b", dtype="bfloat16",
                                  seed=1)
    toks = _tokens(1, 2, 16, cfg_t.vocab)
    x = jp["embed"][jnp.asarray(toks)] * 50.0     # a residual stream's scale
    positions = jnp.broadcast_to(jnp.arange(16), (2, 16))
    layer = jax.tree.map(lambda a: a[0], jp["blocks"][str(pos)])
    exp, aux_e, _ = jax_T._apply_block(layer, cfg_j, pos, x, positions)
    out, aux, _ = T._apply_block(
        T._layer(tp["blocks"][str(pos)], 0), cfg_t, pos,
        torch.from_numpy(np.asarray(x, np.float32)).bfloat16(),
        torch.from_numpy(np.array(positions)))
    assert out.dtype == torch.bfloat16
    assert _rel(out, exp) <= BF16_TOL
    if cfg_t.block_pattern[pos][1] == "moe":
        np.testing.assert_allclose(float(aux), float(aux_e), rtol=1e-2)
    else:
        assert aux is None and float(aux_e) == 0.0


@pytest.mark.parametrize("arch", HYBRID)
def test_init_cache_matches_reference(arch):
    cfg_t, cfg_j = _cfgs(arch, dtype="bfloat16")
    exp = jax_T.init_cache(cfg_j, 3, 20)
    out = T.init_cache(cfg_t, 3, 20, device="cpu")
    assert set(out) == set(exp)
    for pos, entry in exp.items():
        assert set(out[pos]) == set(entry), pos
        for name, leaf in entry.items():
            t = out[pos][name]
            assert tuple(t.shape) == leaf.shape, (pos, name)
            assert str(t.dtype).removeprefix("torch.") == str(leaf.dtype)
            assert not t.any()


@pytest.mark.parametrize("arch", HYBRID)
def test_prefill_cache_and_decode_steps_match_reference(arch):
    """The packed prefill cache (K/V zero-padded, conv and ssm states) and
    four teacher-forced decode steps from it, at per-lane positions."""
    cfg_t, cfg_j, jp, tp = _model(arch, seed=2)
    toks = _tokens(2, 2, 15, cfg_t.vocab)
    _, _, cache_e = jax_T.forward(jp, cfg_j, tokens=jnp.asarray(toks[:, :11]),
                                  return_cache=True, cache_len=16)
    _, _, cache = T.forward(tp, cfg_t, tokens=torch.from_numpy(toks[:, :11]),
                            return_cache=True, cache_len=16)
    for pos, entry in cache_e.items():
        for name, leaf in entry.items():
            assert tuple(cache[pos][name].shape) == leaf.shape
            assert _rel(cache[pos][name], leaf) <= F32_TOL, (pos, name)
    for t in range(11, 15):
        exp, cache_e = jax_T.decode_step(
            jp, cfg_j, jnp.asarray(toks[:, t:t + 1]), cache_e,
            jnp.asarray([t, t], jnp.int32))
        out, cache = T.decode_step(tp, cfg_t,
                                   torch.from_numpy(toks[:, t:t + 1]), cache,
                                   torch.tensor([t, t]))
        assert _rel(out, exp) <= F32_TOL, t


@pytest.mark.parametrize("arch", HYBRID)
def test_serve_continuous_gives_the_reference_token_ids(arch):
    cfg_t, cfg_j, jp, tp = _model(arch, seed=3)
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, cfg_t.vocab, size=rng.integers(3, 12))
               for _ in range(5)]
    out = serve.serve_continuous(tp, cfg_t, prompts, lanes=2, max_len=24,
                                 max_new=6)
    exp = jax_serve.serve_continuous(jp, cfg_j, prompts, lanes=2,
                                     max_len=24, max_new=6)
    assert out == exp
    assert sorted(out) == list(range(5))


def test_generate_gives_the_reference_token_ids():
    cfg_t, cfg_j, jp, tp = _model("jamba-1.5-large-398b", seed=4)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg_t.vocab, size=rng.integers(3, 9))
               for _ in range(3)]
    assert serve.generate(tp, cfg_t, prompts, max_new=5, max_len=16) == \
        jax_serve.generate(jp, cfg_j, prompts, max_new=5, max_len=16)


@pytest.mark.parametrize("plen", [1, 2])
def test_short_prompt_decodes_as_its_full_forward(plen):
    """A prompt shorter than d_conv - 1 = 3 tokens (the reference cannot
    refill a lane with one): prefill, then teacher-forced decode steps give
    the port's own full forward (dropless, so grouping changes nothing);
    ``serve_continuous`` serves such prompts."""
    cfg_t, _, _, tp = _model("jamba-1.5-large-398b", seed=5,
                             capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(5, 1, 7, cfg_t.vocab))
    full, _ = T.forward(tp, cfg_t, tokens=toks)
    logits, _, cache = T.forward(tp, cfg_t, tokens=toks[:, :plen],
                                 return_cache=True, cache_len=8)
    steps = [logits]
    for t in range(plen, 7):
        out, cache = T.decode_step(tp, cfg_t, toks[:, t:t + 1], cache, t)
        steps.append(out)
    assert _rel(torch.cat(steps, dim=1), full.numpy()) <= F32_TOL
    prompts = [toks[0, :plen].numpy(), toks[0, :5].numpy()]
    res = serve.serve_continuous(tp, cfg_t, prompts, lanes=2, max_len=16,
                                 max_new=4)
    assert [len(res[i]) for i in range(2)] == [4, 4]


def test_decode_matches_forward_dropless():
    """The reference's own check (``tests/test_decode_parity.py``) on the
    port: decode token by token from an empty cache reproduces forward, in
    the dropless regime."""
    cfg_t, _, _, tp = _model("jamba-1.5-large-398b", seed=6,
                             capacity_factor=16.0)
    toks = torch.from_numpy(_tokens(6, 2, 9, cfg_t.vocab))
    full, _ = T.forward(tp, cfg_t, tokens=toks)
    cache = T.init_cache(cfg_t, 2, 9, device="cpu")
    steps = []
    for t in range(9):
        out, cache = T.decode_step(tp, cfg_t, toks[:, t:t + 1], cache, t)
        steps.append(out)
    assert _rel(torch.cat(steps, dim=1), full.numpy()) <= F32_TOL


def test_expert_share_of_the_reference_tree_runs():
    """The port on a share of the reference's params: only the held experts
    are carried over, and the forward runs on them."""
    cfg_t, _, jp, _ = _model("jamba-1.5-large-398b", seed=7)
    cfg = dataclasses.replace(cfg_t, moe=dataclasses.replace(
        cfg_t.moe, expert_share=(1, 2)))
    tp = params_from_jax(take_expert_share(jp, cfg), "cpu")
    moe = tp["blocks"]["1"]["mlp"]
    assert moe["w_gate"].shape[:2] == (1, cfg.moe.n_experts // 2)
    np.testing.assert_array_equal(
        moe["w_up"].numpy(), np.asarray(jp["blocks"]["1"]["mlp"]["w_up"])[
            :, cfg.moe.n_experts // 2:])
    out, _ = T.forward(tp, cfg, tokens=torch.zeros((1, 5), dtype=torch.long))
    assert bool(torch.isfinite(out).all())
    assert T.init_lm(cfg, device="cpu")["blocks"]["3"]["mlp"]["w_down"] \
        .shape == (1, 2, cfg.d_ff, cfg.d_model)


def test_served_config_is_one_chips_share_of_jamba():
    full = get_config("jamba-1.5-large-398b")
    cut = get_config("jamba-1.5-large-398b-1chip")
    assert dataclasses.replace(cut, name=full.name, n_layers=full.n_layers,
                               moe=full.moe) == full
    assert cut.n_layers == len(cut.block_pattern) == 8
    assert cut.moe.expert_share == (0, 2) and cut.moe.n_experts == 16
    assert [m for m, _ in cut.block_pattern].count("mamba") == 7
    assert [f for _, f in cut.block_pattern].count("moe") == 4


def test_serve_cli_runs_the_hybrid_on_cpu():
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "jamba-1.5-large-398b-1chip", "--smoke", "--device", "cpu",
         "--requests", "3", "--max-new", "4"],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    last = proc.stdout.splitlines()[-1]
    assert '"conv1d_causal_launches": 0' in last    # the CPU runs plain
    assert k8.launches == 0


def test_decode_parity_probe_on_cpu():
    """``launch/decode_parity`` (phase 20's measurement and its diagnosis)
    on the smoke Jamba in f32: decode reproduces forward, pinning the
    routing to forward's own choices overrides none of them and changes
    nothing, and the f32 "truth" of an f32 model is the model itself."""
    from repro_torch.launch import decode_parity
    out = decode_parity.main(["--arch", "jamba-1.5-large-398b", "--smoke",
                              "--device", "cpu", "--batch", "2",
                              "--prefill", "12", "--steps", "4",
                              "--pin-routing", "--truth"])
    assert out["rel"] <= F32_TOL and out["prefill_rel"] <= F32_TOL
    assert len(out["per_step"]) == 4 and out["argmax_agree"] == 1.0
    assert out["decode_k8_launches"] == 0
    pinned = out["pinned"]
    assert pinned["routing_differ"] == 0
    assert pinned["routing_decisions"] == 4 * 2 * (12 + 4)
    assert pinned["rel"] == out["rel"]
    assert out["truth"]["forward_rel"] == 0.0
    assert out["truth"]["pinned_forward_rel"] == 0.0
