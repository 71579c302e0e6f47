"""Quickstart, the counterpart of ``examples/quickstart.py``: train a small
LM end to end and generate from it.

  PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu
  PYTHONPATH=src python -m repro_torch.launch.quickstart      # on the card

Qwen2-1.5B's smoke config (Dh 16, which K7 and its backward take, so it
also trains on the card) for 40 AdamW steps over 8 synthetic batches, then
greedy generation through ``launch.serve.generate``.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data import SyntheticLMData
from repro_torch.launch.serve import generate
from repro_torch.launch.train import build


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    ap.add_argument("--steps", type=int, default=40)
    args = ap.parse_args(argv)
    cfg = smoke_config(get_config("qwen2-1.5b"))
    print(f"model: {cfg.name}  params={cfg.param_count() / 1e6:.2f}M")
    state, step = build(cfg, lr=3e-3, device=args.device)
    data = SyntheticLMData(vocab=cfg.vocab, seq_len=32, global_batch=8)
    losses = []
    for i in range(args.steps):
        state, metrics = step(state, data.batch_at(i % 8))
        losses.append(float(metrics["loss"]))
        if i % 10 == 0:
            print(f"step {i:3d}  loss={losses[-1]:.3f}  "
                  f"|g|={float(metrics['grad_norm']):.3f}")
    prompts = [data.batch_at(0)["tokens"][0, :8]]
    with torch.no_grad():
        out = generate(state["params"], cfg, prompts, max_new=12, max_len=64)
    print("prompt :", [int(t) for t in prompts[0]])
    print("genout :", out[0])
    return {"losses": losses, "generated": out[0]}


if __name__ == "__main__":
    main()
