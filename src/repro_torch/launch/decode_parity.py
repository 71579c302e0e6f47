"""Decode against forward: a prompt's prefill and teacher-forced
``decode_step``s against ``forward`` over the whole sequence, in the MoE's
dropless regime (capacity factor 16, as ``tests/test_decode_parity.py``
defines the check: capacity drops legitimately differ between a long group
and a 1-token group).

  PYTHONPATH=src python -m repro_torch.launch.decode_parity \
      --arch jamba-1.5-large-398b-1chip --pin-routing
  PYTHONPATH=src python -m repro_torch.launch.decode_parity \
      --arch jamba-1.5-large-398b-1chip --expert-share 0 8 --truth
  PYTHONPATH=src python -m repro_torch.launch.decode_parity --smoke \
      --arch jamba-1.5-large-398b --device cpu --pin-routing --truth

``measure`` is what ``chip_smoke.py``'s phase 20 holds to its limit.  The
options take the diagnosis further:

- ``--pin-routing`` runs prefill and decode again with every MoE routing
  decision taken from forward's (through the ``moe.route`` seam), and
  counts the decisions the paths would take otherwise: what is left is the
  error of the decode path itself, without the jumps a flipped expert gives.
- ``--truth`` holds the model's forward and decode against ``forward`` of
  an f32 copy of the same params (the model's dtype rounds only the
  activations then), as they are and with the routing pinned to the f32
  forward's: how far the model's own rounding moves its logits.

Weights are random from seed 0; tokens from ``numpy.random.default_rng(20)``.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.kernels import conv1d_causal as k8
from repro_torch.nn import moe
from repro_torch.nn import transformer as T

CAPACITY_FACTOR = 16.0


class Router:
    """Stands in for ``moe.route``.  Without ``pinned`` it records each
    call's choices (one (G,S,k) index tensor per MoE layer of a forward);
    with ``pinned`` it hands those out again, sliced to ``window`` (the
    positions of the current call; groups are batch rows here, since the
    sequences are shorter than ``moe.GROUP_SIZE``), with the gate values
    renormalised over them, and counts the decisions it overrode."""

    def __init__(self, pinned=None):
        self.route = moe.route
        self.recorded, self.pinned = [], pinned
        self.window, self.calls = (0, None), 0
        self.differ = self.decisions = 0

    def __call__(self, probs, k):
        vals, idx = self.route(probs, k)
        if self.pinned is None:
            self.recorded.append(idx)
            return vals, idx
        ref = self.pinned[self.calls % len(self.pinned)]
        ref = ref[:, self.window[0]:self.window[1]]
        self.calls += 1
        self.differ += int((idx.sort(-1).values != ref.sort(-1).values)
                           .any(-1).sum())
        self.decisions += ref.shape[0] * ref.shape[1]
        vals = probs.gather(-1, ref)
        return vals / vals.sum(-1, keepdim=True).clamp_min(1e-9), ref


def _with_router(router, fn):
    route = moe.route
    moe.route = router
    try:
        return fn()
    finally:
        moe.route = route


def _paths(params, cfg, toks, lp, router=None):
    """Prefill lp tokens, then teacher-forced decode steps over the rest:
    (prefill logits, decode logits, K8 launches in the decode steps)."""
    steps = toks.shape[1] - lp

    def run():
        if router is not None:
            router.window = (0, lp)
        logits, _, cache = T.forward(params, cfg, tokens=toks[:, :lp],
                                     return_cache=True, cache_len=lp + steps)
        before = k8.launches
        outs = []
        for t in range(lp, lp + steps):
            if router is not None:
                router.window = (t, t + 1)
            out, cache = T.decode_step(params, cfg, toks[:, t:t + 1], cache, t)
            outs.append(out)
        return logits, torch.cat(outs, dim=1), k8.launches - before
    return run() if router is None else _with_router(router, run)


def _forward(params, cfg, toks, router=None):
    if router is None:
        return T.forward(params, cfg, tokens=toks)[0]
    return _with_router(router, lambda: T.forward(params, cfg,
                                                  tokens=toks)[0])


def _rel(out, ref) -> float:
    """max |out - ref| / max |ref|, in f32."""
    out, ref = out.float(), ref.float()
    return float((out - ref).abs().max() / ref.abs().max())


def _f32(tree):
    """A copy of a params tree with every leaf in f32."""
    if isinstance(tree, dict):
        return {key: _f32(v) for key, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree.clone()


def dropless(cfg):
    """``cfg`` with the MoE's capacity factor at CAPACITY_FACTOR."""
    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=CAPACITY_FACTOR))


def tokens(cfg, batch: int, length: int, seed: int, device):
    return torch.from_numpy(np.random.default_rng(seed + 20).integers(
        0, cfg.vocab, (batch, length))).to(device)


@torch.no_grad()
def measure(params, cfg, toks, lp: int, *, pin_routing: bool = False,
            truth=None) -> dict:
    """Decode against forward of ``cfg`` (made dropless here) on ``toks``
    (B, lp + steps): max |diff| / max |logit| of the decode logits
    (``rel``, and ``per_step``), the decode argmax agreement, the prefill's
    own logits against forward's on the shared positions (``prefill_rel``)
    and K8's launches in the decode steps.  ``pin_routing`` adds the same
    with forward's routing pinned; ``truth`` (f32 params, the same values)
    adds the paths against the f32 forward."""
    cfg = dropless(cfg)
    steps = toks.shape[1] - lp
    rec = Router() if pin_routing and cfg.moe is not None else None
    full = _forward(params, cfg, toks, rec)
    logits, dec, launches = _paths(params, cfg, toks, lp)
    ref = full[:, lp:]
    scale = float(ref.float().abs().max())
    out = dict(dtype=cfg.dtype, batch=toks.shape[0], prefill=lp, steps=steps,
               rel=_rel(dec, ref),
               per_step=[float((dec[:, i] - ref[:, i]).float().abs().max())
                         / scale for i in range(steps)],
               argmax_agree=float((dec.argmax(-1) == ref.argmax(-1))
                                  .float().mean()),
               prefill_rel=_rel(logits, full[:, :lp]),
               decode_k8_launches=launches)
    if rec is not None:
        pin = Router(rec.recorded)
        pin_logits, pin_dec, _ = _paths(params, cfg, toks, lp, pin)
        out["pinned"] = dict(rel=_rel(pin_dec, ref),
                             prefill_rel=_rel(pin_logits, full[:, :lp]),
                             routing_differ=pin.differ,
                             routing_decisions=pin.decisions)
    if truth is not None:
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        rec32 = Router() if cfg.moe is not None else None
        full32 = _forward(truth, cfg32, toks, rec32)
        out["truth"] = dict(forward_rel=_rel(full, full32),
                            decode_rel=_rel(dec, full32[:, lp:]))
        if rec32 is not None:
            pin = Router(rec32.recorded)
            out["truth"]["pinned_forward_rel"] = _rel(
                _forward(params, cfg, toks, pin), full32)
            pin_dec = Router(rec32.recorded)
            out["truth"]["pinned_decode_rel"] = _rel(
                _paths(params, cfg, toks, lp, pin_dec)[1], full32[:, lp:])
            out["truth"]["routing_differ"] = pin.differ
            out["truth"]["routing_decisions"] = pin.decisions
        del full32
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(),
                    default="jamba-1.5-large-398b-1chip")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (tiny widths)")
    ap.add_argument("--expert-share", type=int, nargs=2, default=None,
                    metavar=("INDEX", "COUNT"))
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--prefill", type=int, default=96)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--pin-routing", action="store_true")
    ap.add_argument("--truth", action="store_true",
                    help="also against forward of an f32 copy of the params")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if args.expert_share:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_share=tuple(args.expert_share)))
    device = resolve_device(args.device)
    params = T.init_lm(cfg, torch.Generator(device=device).manual_seed(0),
                       device=device)
    truth = _f32(params) if args.truth else None
    toks = tokens(cfg, args.batch, args.prefill + args.steps, 0, device)
    out = measure(params, cfg, toks, args.prefill,
                  pin_routing=args.pin_routing, truth=truth)
    out.update(arch=cfg.name, expert_share=(cfg.moe.expert_share
                                            if cfg.moe else None),
               device=str(device))
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(device)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
