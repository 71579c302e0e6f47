"""Decoder-only LM, the counterpart of ``repro/nn/transformer.py``.

Params keep the reference's tree: ``embed``, ``final_norm``, ``head`` (when
untied) and ``blocks[str(pos)]`` for each position of ``block_pattern``,
whose every leaf has a leading "layers" axis (the reference stacks over
pattern repeats for its ``lax.scan``), so a converted tree maps 1:1.  The
port loops over repeats and positions in Python and indexes views of the
stacked tensors: that loop is the counterpart of the scan.  Hybrid archs
(Jamba: 1 attention + 7 Mamba mixers per repeat, MoE on odd positions) are
longer patterns.

Three entry points, as in the reference:
  forward      — teacher-forced full sequence (prefill), logits at every
                 position and the MoE aux loss, optionally the packed
                 decode cache
  decode_step  — one token against the cache, written in place
  init_cache   — allocate the decode cache for (batch, max_len): K/V for
                 attention, conv and ssm states for Mamba

The mixers "attn" and "mamba" and the MLPs "dense" and "moe" are ported; a
config with an RWKV entry raises ``NotImplementedError``.  ``lm_loss``
waits for the LM training slice.
"""
from __future__ import annotations

import torch

from repro_torch.backend import resolve_device
from repro_torch.nn import attention, mamba, mlp, moe
from repro_torch.nn.common import rms_norm

UNPORTED = {"rwkv", "rwkv_cm"}


def _check_pattern(cfg) -> None:
    other = sorted({tuple(e) for e in cfg.block_pattern
                    if UNPORTED & set(e)})
    if other:
        raise NotImplementedError(
            f"{cfg.name}: block pattern entries {other} are not ported; the "
            f"port runs the attn and mamba mixers with dense or moe MLPs "
            f"(the RWKV mixer and channel mix wait for their slice: ROADMAP "
            f"Queue 1 item 11)")


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

def init_block(generator, cfg, pos: int, dtype, device=None):
    """One layer at pattern position ``pos``: mixer + MLP + 2 norms."""
    mixer, mlp_kind = cfg.block_pattern[pos]
    mix = attention if mixer == "attn" else mamba
    ff = mlp if mlp_kind == "dense" else moe
    return {"mixer": mix.init(generator, cfg, dtype, device),
            "mlp": ff.init(generator, cfg, dtype, device),
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
        str(pos): _stack([init_block(generator, cfg, pos, dtype, device)
                          for _ in range(cfg.pattern_repeats)])
        for pos in range(len(cfg.block_pattern))}
    return params


# ---------------------------------------------------------------------------
# forward (prefill)
# ---------------------------------------------------------------------------

def _apply_block(p, cfg, pos: int, x, positions, *,
                 collect_state: bool = False):
    """-> (x, aux f32 scalar or None, decode state or None)."""
    mixer, mlp_kind = cfg.block_pattern[pos]
    aux = state = None
    h = rms_norm(x, p["norm1"], eps=cfg.norm_eps)
    if mixer == "attn":
        if collect_state:
            y, (k, v) = attention.apply(p["mixer"], cfg, h, positions,
                                        return_kv=True)
            state = {"k": k, "v": v}
        else:
            y = attention.apply(p["mixer"], cfg, h, positions)
    elif collect_state:
        y, (cs, hs) = mamba.apply(p["mixer"], cfg, h, return_state=True)
        state = {"conv": cs, "ssm": hs}
    else:
        y = mamba.apply(p["mixer"], cfg, h)
    x = x + y
    h = rms_norm(x, p["norm2"], eps=cfg.norm_eps)
    if mlp_kind == "dense":
        y = mlp.apply(p["mlp"], cfg, h)
    else:
        y, losses = moe.apply(p["mlp"], cfg, h)
        aux = 0.01 * losses["lb_loss"] + 1e-3 * losses["z_loss"]
    return x + y, aux, state


def forward(params, cfg, *, tokens=None, embeds=None, positions=None,
            return_cache: bool = False, cache_len: int | None = None):
    """-> (logits (B,L,V), aux) [+ cache].  ``embeds`` (B,L,D) bypasses the
    token embedding (the VLM/audio frontend stubs).  ``aux`` is the
    reference's MoE loss term (0.01 lb_loss + 1e-3 z_loss summed over the
    MoE layers), a zero f32 scalar for dense configs.  With
    ``return_cache`` every layer's decode state comes back in the cache
    layout: keys and values zero-padded to ``cache_len`` positions, Mamba
    conv and ssm states as they are."""
    _check_pattern(cfg)
    if embeds is None:
        embeds = params["embed"][tokens.long()]
    x = embeds
    b, l, _ = x.shape
    if positions is None:
        positions = torch.arange(l, device=x.device).expand(b, l)
    npos = len(cfg.block_pattern)
    states = {str(pos): [] for pos in range(npos)}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.pattern_repeats):
        for pos in range(npos):
            x, aux_i, st = _apply_block(
                _layer(params["blocks"][str(pos)], i), cfg, pos, x, positions,
                collect_state=return_cache)
            if aux_i is not None:
                aux = aux + aux_i
            states[str(pos)].append(st)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    logits = x @ _head(params)
    if return_cache:
        return logits, aux, {pos: _pack_states(sts, cache_len)
                             for pos, sts in states.items()}
    return logits, aux


def _pack_states(states: list[dict], cache_len: int | None) -> dict:
    """One pattern position's per-layer prefill states, stacked over the
    layers as the decode cache: K/V, each (B,Hkv,L,Dh), as
    (layers,B,Hkv,cache_len,Dh), zero past L; Mamba's conv (B,d_conv-1,di)
    and ssm (B,di,ds) states unpadded."""
    out = {}
    for name, first in states[0].items():
        if name in ("k", "v"):
            b, h, l, d = first.shape
            packed = first.new_zeros((len(states), b, h, cache_len or l, d))
            for i, st in enumerate(states):
                packed[i, :, :, :l] = st[name]
        else:
            packed = torch.stack([st[name] for st in states])
        out[name] = packed
    return out


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device=None) -> dict:
    """Allocate the zero decode cache, stacked over pattern repeats, one
    entry per pattern position: attention {"k", "v"}, each (layers, batch,
    Hkv, max_len, Dh) in the model dtype; Mamba {"conv" (layers, batch,
    d_conv-1, d_inner) in the model dtype, "ssm" (layers, batch, d_inner,
    d_state) f32}."""
    _check_pattern(cfg)
    device = resolve_device(device)
    reps, dtype = cfg.pattern_repeats, _dtype(cfg)
    cache = {}
    for pos, (mixer, _) in enumerate(cfg.block_pattern):
        if mixer == "attn":
            shape = (reps, batch, cfg.n_kv_heads, max_len, cfg.head_dim)
            cache[str(pos)] = {name: torch.zeros(shape, dtype=dtype,
                                                 device=device)
                               for name in ("k", "v")}
        else:
            cache[str(pos)] = {
                "conv": torch.zeros((reps, batch, cfg.d_conv - 1,
                                     cfg.d_inner), dtype=dtype,
                                    device=device),
                "ssm": torch.zeros((reps, batch, cfg.d_inner, cfg.d_state),
                                   dtype=torch.float32, device=device)}
    return cache


def _decode_block(p, cfg, pos: int, x, c, idx):
    """One layer of one decode step; ``c`` holds views of this layer's
    cache entries, updated in place."""
    mixer, mlp_kind = cfg.block_pattern[pos]
    h = rms_norm(x, p["norm1"], eps=cfg.norm_eps)
    if mixer == "attn":
        y, _ = attention.decode(p["mixer"], cfg, h, (c["k"], c["v"]), idx)
    else:
        y, _ = mamba.decode(p["mixer"], cfg, h, (c["conv"], c["ssm"]))
    x = x + y
    h = rms_norm(x, p["norm2"], eps=cfg.norm_eps)
    if mlp_kind == "dense":
        return x + mlp.apply(p["mlp"], cfg, h)
    return x + moe.apply(p["mlp"], cfg, h)[0]


def decode_step(params, cfg, tokens, cache, idx, *, embeds=None):
    """tokens: (B,1) [or embeds (B,1,D)]; idx: the position, an int (lockstep
    batch) or a (B,) tensor (per-lane positions).  Writes this token's K/V
    and the new Mamba states into ``cache`` in place; returns (logits
    (B,1,V), cache)."""
    _check_pattern(cfg)
    x = params["embed"][tokens.long()] if embeds is None else embeds
    idx = torch.as_tensor(idx, device=x.device)
    npos = len(cfg.block_pattern)
    for i in range(cfg.pattern_repeats):
        for pos in range(npos):
            x = _decode_block(_layer(params["blocks"][str(pos)], i), cfg,
                              pos, x, _layer(cache[str(pos)], i), idx)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return x @ _head(params), cache
