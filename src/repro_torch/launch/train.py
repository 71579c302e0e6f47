"""Single-device LM trainer, the counterpart of ``repro/launch/train.py``:
model init -> train step (AdamW, the global-norm clip, ``accum_steps``
microbatches) -> a loop over the data pipeline -> metrics.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 5 --seq-len 512

On the card every attention forward is K7 and its gradient K7's backward
kernel (``kernels/attention.flash_attention_bwd``), every Mamba conv1d K8
with K8' (``kernels/conv1d_causal.conv1d_causal_bwd``) and every MoE
grouped matmul K9 with K9' (``kernels/moe_gmm.moe_gmm_bwd``), so hybrid
and MoE archs train there too; Jamba-1.5-Large trains on one card as
``jamba-1.5-large-398b-train-1chip`` (two layers at the published widths,
4 of 16 experts held):

  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-1.5-large-398b-train-1chip --steps 3 --seq-len 512 --global-batch 2

The weights are random, drawn from seed 0 (``build(seed=)``); batches come
from ``data.pipeline.make_pipeline`` (synthetic tokens, or
``--data-path``).

The reference's mesh, checkpoint and chaos flags (``--production-mesh``,
``--model-parallel``, ``--ckpt-dir``, ``--ckpt-every``, ``--chaos-seed``,
``--chaos-hosts``) belong to data parallelism and resilience (ROADMAP
Queue 1 item 10) and are not ported: argparse refuses them.
"""
from __future__ import annotations

import argparse
import json
import time

import torch

from repro_torch.backend import resolve_device
from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.data import make_pipeline
from repro_torch.launch.serve import _sync
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.train.step import init_train_state, make_train_step


def build(cfg, *, lr: float = 3e-4, accum_steps: int = 1, seed: int = 0,
          device=None):
    """AdamW (the reference's: factored bf16 state for ``cfg.factored_opt``,
    else f32), the train state with random params from ``seed`` on
    ``device`` (default cuda) and the train step.  Returns (state, step)."""
    opt = AdamW(factored=cfg.factored_opt,
                state_dtype=(torch.bfloat16 if cfg.factored_opt
                             else torch.float32))
    device = resolve_device(device)
    state = init_train_state(
        cfg, opt, torch.Generator(device=device).manual_seed(seed),
        device=device)
    return state, make_train_step(cfg, opt, lr=lr, accum_steps=accum_steps)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (tiny widths, f32)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = resolve_device(args.device)
    state, step = build(cfg, lr=args.lr, accum_steps=args.accum_steps,
                        device=device)
    # params counts every expert of the config; held, what this device
    # holds (a share of them under ``MoECfg.expert_share``)
    held = sum(p.numel() for p in tree_leaves(state["params"]))
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"held={held / 1e6:.1f}M device={device}")
    data = make_pipeline(cfg, seq_len=args.seq_len,
                         global_batch=args.global_batch,
                         path=args.data_path)
    log = []
    _sync(device)
    t0 = time.perf_counter()
    for i in range(args.steps):
        state, metrics = step(state, data.batch_at(i))
        log.append({"step": i, "loss": float(metrics["loss"]),
                    "grad_norm": float(metrics["grad_norm"])})
    _sync(device)
    seconds = time.perf_counter() - t0
    for m in log[:3] + log[-3:]:
        print(json.dumps(m))
    tokens = args.steps * args.global_batch * args.seq_len
    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "tokens_per_s": tokens / seconds, "first": log[0],
               "last": log[-1]}
    print(f"tokens/s={tokens / seconds:.0f}")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
