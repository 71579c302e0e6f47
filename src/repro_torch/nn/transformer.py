"""Decoder-only LM, the counterpart of ``repro/nn/transformer.py``.

Params keep the reference's tree: ``embed``, ``final_norm``, ``head`` (when
untied) and ``blocks[str(pos)]`` for each position of ``block_pattern``,
whose every leaf has a leading "layers" axis (the reference stacks over
pattern repeats for its ``lax.scan``), so a converted tree maps 1:1.  The
port loops over repeats and positions in Python and indexes views of the
stacked tensors: that loop is the counterpart of the scan.  Hybrid archs
(Jamba: 1 attention + 7 Mamba mixers per repeat, MoE on odd positions) are
longer patterns.

Three entry points, as in the reference, and the loss:
  forward      — teacher-forced full sequence (train / prefill), logits at
                 every position and the MoE aux loss, optionally the packed
                 decode cache
  decode_step  — one token against the cache, written in place
  init_cache   — allocate the decode cache for (batch, max_len): K/V for
                 attention, conv and ssm states for Mamba, the token shifts
                 and WKV state for RWKV
  lm_loss      — softmax cross-entropy of the logits plus the aux loss
                 (``lm_loss_embeds`` from embeddings)

Every mixer ("attn", "mamba", "rwkv") and MLP ("dense", "moe", "rwkv_cm")
of the reference is ported.  With ``cfg.remat``, where autograd records,
``forward`` runs each repeat of the pattern, and each block of a pattern
longer than one, under ``torch.utils.checkpoint`` (non-reentrant), the
reference's ``jax.checkpoint`` of its scan body and inner blocks
(``transformer.py:157-168``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.backend import resolve_device
from repro_torch.nn import attention, mamba, mlp, moe, rwkv
from repro_torch.nn.common import rms_norm, rms_norm_specs, softmax_xent

MIXERS = {"attn": attention, "mamba": mamba, "rwkv": rwkv}
MLP_SPECS = {"dense": mlp.specs, "moe": moe.specs,
             "rwkv_cm": mlp.rwkv_cm_specs}


def _dtype(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _layer(tree: dict, i: int) -> dict:
    """Views of layer ``i`` of a stacked block tree."""
    return {key: _layer(v, i) if isinstance(v, dict) else v[i]
            for key, v in tree.items()}


def _layers(tree: dict) -> dict:
    """Every layer of a stacked block tree as views, one ``unbind`` per
    leaf: its backward stacks the layers' gradients once, where indexing
    layer by layer would scatter each into a zero copy of the whole stack
    and sum as many copies as there are layers."""
    return {key: _layers(v) if isinstance(v, dict) else v.unbind(0)
            for key, v in tree.items()}


def _records(params, x) -> bool:
    """Whether autograd records this forward: grad mode on and the input or
    a block leaf requiring grad."""
    def leaves(tree):
        for v in tree.values():
            yield from leaves(v) if isinstance(v, dict) else (v,)
    return torch.is_grad_enabled() and (x.requires_grad or any(
        t.requires_grad for t in leaves(params["blocks"])))


def _head(params):
    head = params.get("head")
    return head if head is not None else params["embed"].T


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def init_block(generator, cfg, pos: int, dtype, device=None):
    """One layer at pattern position ``pos``: mixer + MLP + 2 norms."""
    mixer, mlp_kind = cfg.block_pattern[pos]
    ff = {"dense": mlp.init, "moe": moe.init,
          "rwkv_cm": mlp.init_rwkv_cm}[mlp_kind]
    return {"mixer": MIXERS[mixer].init(generator, cfg, dtype, device),
            "mlp": ff(generator, cfg, dtype, device),
            "norm1": torch.ones((cfg.d_model,), dtype=dtype, device=device),
            "norm2": torch.ones((cfg.d_model,), dtype=dtype, device=device)}


def block_specs(cfg, pos: int) -> dict:
    """The logical axes of ``init_block``'s leaves at pattern position
    ``pos`` (one layer, before stacking)."""
    mixer, mlp_kind = cfg.block_pattern[pos]
    return {"mixer": MIXERS[mixer].specs(cfg),
            "mlp": MLP_SPECS[mlp_kind](cfg),
            "norm1": rms_norm_specs(), "norm2": rms_norm_specs()}


def param_specs(cfg) -> dict:
    """The reference's spec tree of ``init_lm``'s params (``init_lm`` of
    ``repro/nn/transformer.py`` returns it beside them), built without
    drawing a weight: a tuple of logical axis names per leaf, ``embed``
    ("vocab", "embed"), ``head`` ("embed", "vocab"), and every block leaf
    with the stacked "layers" axis first."""
    def stacked(tree):
        return {key: stacked(v) if isinstance(v, dict) else ("layers",) + v
                for key, v in tree.items()}
    specs = {"embed": ("vocab", "embed"), "final_norm": rms_norm_specs()}
    if not cfg.tie_embeddings:
        specs["head"] = ("embed", "vocab")
    specs["blocks"] = {str(pos): stacked(block_specs(cfg, pos))
                       for pos in range(len(cfg.block_pattern))}
    return specs


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
    ``device`` (default cuda).  On the meta device nothing is drawn: the
    tree of shapes and dtypes, for sizing and placements.  Only the
    params, which many callers take; ``param_specs(cfg)`` is the
    reference's spec tree of them."""
    device = resolve_device(device)
    if generator is None and device.type != "meta":
        generator = torch.Generator(device=device).manual_seed(0)
    dtype = _dtype(cfg)

    def normal(shape, std):
        w = torch.randn(shape, generator=generator, device=(
            generator.device if generator is not None else device))
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
    elif mixer == "mamba":
        if collect_state:
            y, (cs, hs) = mamba.apply(p["mixer"], cfg, h, return_state=True)
            state = {"conv": cs, "ssm": hs}
        else:
            y = mamba.apply(p["mixer"], cfg, h)
    elif collect_state:
        y, (xp, sw) = rwkv.apply(p["mixer"], cfg, h, return_state=True)
        state = {"x_prev": xp, "s": sw}
    else:
        y = rwkv.apply(p["mixer"], cfg, h)
    x = x + y
    h = rms_norm(x, p["norm2"], eps=cfg.norm_eps)
    if mlp_kind == "dense":
        y = mlp.apply(p["mlp"], cfg, h)
    elif mlp_kind == "moe":
        y, losses = moe.apply(p["mlp"], cfg, h)
        aux = 0.01 * losses["lb_loss"] + 1e-3 * losses["z_loss"]
    else:  # the RWKV channel mix, on the token-shifted h
        if collect_state:
            state = {**(state or {}), "cm_x_prev": h[:, -1, :]}
        y = mlp.apply_rwkv_cm(p["mlp"], cfg, h,
                              F.pad(h, (0, 0, 1, 0))[:, :-1])
    return x + y, aux, state


def forward(params, cfg, *, tokens=None, embeds=None, positions=None,
            return_cache: bool = False, cache_len: int | None = None,
            gather=None):
    """-> (logits (B,L,V), aux) [+ cache].  ``embeds`` (B,L,D) bypasses the
    token embedding (the VLM/audio frontend stubs).  ``aux`` is the
    reference's MoE loss term (0.01 lb_loss + 1e-3 z_loss summed over the
    MoE layers), a zero f32 scalar for dense configs.  With
    ``return_cache`` every layer's decode state comes back in the cache
    layout: keys and values zero-padded to ``cache_len`` positions, the
    other states (Mamba's conv and ssm, RWKV's token shifts and WKV state)
    as they are.  ``gather(path, tree)`` (``train.fsdp.gatherer``) makes
    ``params`` a tree of held slices, each read whole through it: the
    top-level leaves once, a block's leaves at the start of each repeat
    (inside its remat, so the backward gathers them again)."""
    if gather is not None:
        params = {key: v if key == "blocks" else gather((key,), v)
                  for key, v in params.items()}
    if embeds is None:
        embeds = params["embed"][tokens.long()]
    x = embeds
    b, l, _ = x.shape
    if positions is None:
        positions = torch.arange(l, device=x.device).expand(b, l)
    npos = len(cfg.block_pattern)
    states = {str(pos): [] for pos in range(npos)}
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    remat = cfg.remat and not return_cache and _records(params, x)
    inner_remat = remat and npos > 1
    unbound = {pos: _layers(params["blocks"][str(pos)])
               for pos in range(npos)}

    def block(layer_p, xx, *, pos):
        return _apply_block(layer_p, cfg, pos, xx, positions,
                            collect_state=return_cache)

    def repeat(xx, aux_sum, i):
        sts = []
        for pos in range(npos):
            layer_p = _layer(unbound[pos], i)
            if gather is not None:
                layer_p = gather(("blocks", str(pos)), layer_p)
            if inner_remat:
                xx, aux_i, st = checkpoint(block, layer_p, xx, pos=pos,
                                           use_reentrant=False)
            else:
                xx, aux_i, st = block(layer_p, xx, pos=pos)
            if aux_i is not None:
                aux_sum = aux_sum + aux_i
            sts.append(st)
        return xx, aux_sum, sts

    for i in range(cfg.pattern_repeats):
        if remat:
            x, aux, sts = checkpoint(repeat, x, aux, i, use_reentrant=False)
        else:
            x, aux, sts = repeat(x, aux, i)
        for pos, st in enumerate(sts):
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
    (layers,B,Hkv,cache_len,Dh), zero past L; the other states unpadded:
    Mamba's conv (B,d_conv-1,di) and ssm (B,di,ds), RWKV's x_prev and
    cm_x_prev (B,D) and s (B,H,dh,dh)."""
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
    d_state) f32}; RWKV {"x_prev" (layers, batch, D) in the model dtype,
    "s" (layers, batch, H, dh, dh) f32}, and "cm_x_prev" (layers, batch, D)
    for the channel mix."""
    device = resolve_device(device)
    reps, dtype = cfg.pattern_repeats, _dtype(cfg)
    nh = cfg.n_heads
    dh = cfg.d_model // nh

    def zeros(*shape, dt=dtype):
        return torch.zeros((reps, batch) + shape, dtype=dt, device=device)
    cache = {}
    for pos, (mixer, mlp_kind) in enumerate(cfg.block_pattern):
        if mixer == "attn":
            shape = (cfg.n_kv_heads, max_len, cfg.head_dim)
            c = {"k": zeros(*shape), "v": zeros(*shape)}
        elif mixer == "mamba":
            c = {"conv": zeros(cfg.d_conv - 1, cfg.d_inner),
                 "ssm": zeros(cfg.d_inner, cfg.d_state, dt=torch.float32)}
        else:
            c = {"x_prev": zeros(cfg.d_model),
                 "s": zeros(nh, dh, dh, dt=torch.float32)}
        if mlp_kind == "rwkv_cm":
            c["cm_x_prev"] = zeros(cfg.d_model)
        cache[str(pos)] = c
    return cache


def _decode_block(p, cfg, pos: int, x, c, idx):
    """One layer of one decode step; ``c`` holds views of this layer's
    cache entries, updated in place."""
    mixer, mlp_kind = cfg.block_pattern[pos]
    h = rms_norm(x, p["norm1"], eps=cfg.norm_eps)
    if mixer == "attn":
        y, _ = attention.decode(p["mixer"], cfg, h, (c["k"], c["v"]), idx)
    elif mixer == "mamba":
        y, _ = mamba.decode(p["mixer"], cfg, h, (c["conv"], c["ssm"]))
    else:
        y, _ = rwkv.decode(p["mixer"], cfg, h, (c["x_prev"], c["s"]))
    x = x + y
    h = rms_norm(x, p["norm2"], eps=cfg.norm_eps)
    if mlp_kind == "dense":
        return x + mlp.apply(p["mlp"], cfg, h)
    if mlp_kind == "moe":
        return x + moe.apply(p["mlp"], cfg, h)[0]
    y = mlp.apply_rwkv_cm(p["mlp"], cfg, h, c["cm_x_prev"][:, None, :])
    c["cm_x_prev"].copy_(h[:, -1, :])
    return x + y


def decode_step(params, cfg, tokens, cache, idx, *, embeds=None):
    """tokens: (B,1) [or embeds (B,1,D)]; idx: the position, an int (lockstep
    batch) or a (B,) tensor (per-lane positions).  Writes this token's K/V
    and the new Mamba and RWKV states into ``cache`` in place; returns
    (logits (B,1,V), cache)."""
    x = params["embed"][tokens.long()] if embeds is None else embeds
    idx = torch.as_tensor(idx, device=x.device)
    npos = len(cfg.block_pattern)
    for i in range(cfg.pattern_repeats):
        for pos in range(npos):
            x = _decode_block(_layer(params["blocks"][str(pos)], i), cfg,
                              pos, x, _layer(cache[str(pos)], i), idx)
    x = rms_norm(x, params["final_norm"], eps=cfg.norm_eps)
    return x @ _head(params), cache


def lm_loss(params, cfg, tokens, labels):
    """Mean next-token cross-entropy of ``forward`` on ``tokens`` against
    ``labels`` (-1 masked), plus the MoE aux loss."""
    logits, aux = forward(params, cfg, tokens=tokens)
    return softmax_xent(logits, labels) + aux


def lm_loss_embeds(params, cfg, embeds, labels):
    """``lm_loss`` from embeddings (B,L,D) (the VLM/audio frontend stubs)."""
    logits, aux = forward(params, cfg, embeds=embeds)
    return softmax_xent(logits, labels) + aux
