"""Decoder-only LM for the dense configs, the counterpart of
``repro/nn/transformer.py``.

Params keep the reference's tree: ``embed``, ``final_norm``, ``head`` (when
untied) and ``blocks["0"]``, whose every leaf has a leading "layers" axis
(the reference stacks over pattern repeats for its ``lax.scan``), so a
converted tree maps 1:1.  The port loops over layers in Python and indexes
views of the stacked tensors: that loop is the counterpart of the scan.

Three entry points, as in the reference:
  forward      — teacher-forced full sequence (prefill), logits at every
                 position, optionally the packed KV cache
  decode_step  — one token against the cache, written in place
  init_cache   — allocate the decode cache for (batch, max_len)

Only the ("attn", "dense") pattern is ported (every dense config); a
config with a Mamba, RWKV or MoE entry raises ``NotImplementedError``.
``lm_loss`` waits for the LM training slice.
"""
from __future__ import annotations

import torch

from repro_torch.backend import resolve_device
from repro_torch.nn import attention, mlp
from repro_torch.nn.common import rms_norm

PORTED_PATTERN = ("attn", "dense")


def _check_pattern(cfg) -> None:
    other = sorted({tuple(e) for e in cfg.block_pattern} - {PORTED_PATTERN})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block pattern entries {other} are not ported; the "
            f"port runs {PORTED_PATTERN} only (the Mamba, RWKV and MoE "
            f"mixers wait for their slices: ROADMAP Queue 1 item 11)")


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of a stacked block tree."""
    return {key: _layer(v, i) if isinstance(v, dict) else v[i]
            for key, v in tree.items()}


def _head(params):
    head = params.get("head")
    return head if head is not None else params["embed"].T


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(generator, cfg, dtype, device=None):
    """One layer: attention mixer + SwiGLU MLP + 2 norms."""
    return {"mixer": attention.init(generator, cfg, dtype, device),
            "mlp": mlp.init(generator, cfg, dtype, device),
            "norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def _stack(trees: list[dict]) -> dict:
    return {key: _stack([t[key] for t in trees])
            if isinstance(trees[0][key], dict)
            else torch.stack([t[key] for t in trees])
            for key in trees[0]}


def init_lm(cfg, generator: torch.Generator | None = None, *,
            device=None) -> dict:
    """Random params in the reference's distribution and dtype (normal *
    0.02 embeddings, fan-in normal projections, unit norms, zero biases),
    block leaves stacked over pattern repeats.  Drawn from ``generator``
    (default: seed 0 on ``device``) on its device, then moved to
    ``device`` (default cuda).  Only the params: the reference's specs tree
    waits for data parallelism."""
    _check_pattern(cfg)
    device = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = _dtype(cfg)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=generator.device)
        return (w * std).to(dtype=dtype, device=device)

    params = {"embed": normal((cfg.vocab, cfg.d_model), 0.02),
              "final_norm": torch.ones((cfg.d_model,), dtype=dtype,
                                       device=device)}
    if not cfg.tie_embeddings:
        params["head"] = normal((cfg.d_model, cfg.vocab), 0.02)
    params["blocks"] = {
        str(pos): _stack([init_block(generator, cfg, dtype, device)
                          for _ in range(cfg.pattern_repeats)])
        for pos in range(len(cfg.block_pattern))}
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, x, positions, *, collect_state: bool = False):
    state = None
    h = rms_norm(x, p["norm1"], eps=cfg.norm_eps)
    if collect_state:
        y, (k, v) = attention.apply(p["mixer"], cfg, h, positions,
                                    return_kv=True)
        state = {"k": k, "v": v}
    else:
        y = attention.apply(p["mixer"], cfg, h, positions)
    x = x + y
    h = rms_norm(x, p["norm2"], eps=cfg.norm_eps)
    x = x + mlp.apply(p["mlp"], cfg, h)
    return x, state


def forward(params, cfg, *, tokens=None, embeds=None, positions=None,
            return_cache: bool = False, cache_len: int | None = None):
    """-> (logits (B,L,V), aux) [+ cache].  ``embeds`` (B,L,D) bypasses the
    token embedding (the VLM/audio frontend stubs).  ``aux`` is the
    reference's MoE loss term, a zero f32 scalar for dense configs.  With
    ``return_cache`` the keys and values of every layer come back in the
    decode-cache layout, zero-padded to ``cache_len`` positions."""
    _check_pattern(cfg)
    if embeds is None:
        embeds = params["embed"][tokens.long()]
    x = embeds
    b, l, _ = x.shape
    if positions is None:
        positions = torch.arange(l, device=x.device).expand(b, l)
    npos = len(cfg.block_pattern)
    states = {str(pos): [] for pos in range(npos)}
    for i in range(cfg.pattern_repeats):
        for pos in range(npos):
            x, st = _apply_block(_layer(params["blocks"][str(pos)], i), cfg,
                                 x, positions, collect_state=return_cache)
            states[str(pos)].append(st)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = x @ _head(params)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    if return_cache:
        return logits, aux, {pos: _pack_states(sts, cache_len)
                             for pos, sts in states.items()}
    return logits, aux


def _pack_states(states: list[dict], cache_len: int | None) -> dict:
    """One pattern position's per-layer prefill K/V, each (B,Hkv,L,Dh), as
    the stacked decode cache (layers,B,Hkv,cache_len,Dh), zero past L."""
    out = {}
    for name in ("k", "v"):
        first = states[0][name]
        b, h, l, d = first.shape
        s_max = cache_len or l
        packed = first.new_zeros((len(states), b, h, s_max, d))
        for i, st in enumerate(states):
            packed[i, :, :, :l] = st[name]
        out[name] = packed
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Allocate the zero decode cache, stacked over pattern repeats:
    {"0": {"k", "v"}}, each (layers, batch, Hkv, max_len, Dh)."""
    _check_pattern(cfg)
    device = resolve_device(device)
    shape = (cfg.pattern_repeats, batch, cfg.n_kv_heads, max_len,
             cfg.head_dim)
    return {str(pos): {name: torch.zeros(shape, dtype=_dtype(cfg),
                                         device=device)
                       for name in ("k", "v")}
            for pos in range(len(cfg.block_pattern))}


def decode_step(params, cfg, tokens, cache, idx, *, embeds=None):
    """tokens: (B,1) [or embeds (B,1,D)]; idx: the position, an int (lockstep
    batch) or a (B,) tensor (per-lane positions).  Writes this token's K/V
    into ``cache`` in place; returns (logits (B,1,V), cache)."""
    _check_pattern(cfg)
    x = params["embed"][tokens.long()] if embeds is None else embeds
    idx = torch.as_tensor(idx, device=x.device)
    npos = len(cfg.block_pattern)
    for i in range(cfg.pattern_repeats):
        for pos in range(npos):
            p = _layer(params["blocks"][str(pos)], i)
            c = cache[str(pos)]
            h = rms_norm(x, p["norm1"], eps=cfg.norm_eps)
            y, _ = attention.decode(p["mixer"], cfg, h,
                                    (c["k"][i], c["v"][i]), idx)
            x = x + y
            h = rms_norm(x, p["norm2"], eps=cfg.norm_eps)
            x = x + mlp.apply(p["mlp"], cfg, h)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return x @ _head(params), cache
