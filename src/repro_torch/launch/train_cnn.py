"""ResNet-50 SGD training through GxM on one device, the counterpart of the
single-device path of ``examples/train_resnet50_gxm.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_cnn                  # cuda
  PYTHONPATH=src python -m repro_torch.launch.train_cnn --device cpu --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train_cnn --full --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train_cnn --full --warmup

Every conv runs ``core.conv.conv2d_train``: the forward through K1, dI by
the §II-I duality through K1, dW through the update-pass kernel K2.  The
weights are random, drawn from seed 0; the batches come from
``data.pipeline.SyntheticImageData``.  Without ``--full`` the topology has
one block per stage.  ``--warmup``, as in the example, tunes the plans of
every forward, dual and weight-update conv of a step at the run's batch
into the plan cache (``train.step.warmup_cnn_train``, ``REPRO_TUNE_CACHE``)
and runs the steps under "cache".  ``--devices`` and ``--compress`` of the
example wait for the data-parallel slice.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.graph import GxM, resnet50
from repro_torch.train.step import (make_cnn_train_step, to_device,
                                    warmup_cnn_train)


def build_trainer(*, full: bool, num_classes: int = 10, image: int = 64,
                  batch: int = 8, lr: float = 0.05, device=None,
                  seed: int = 0, autotune: str | None = None):
    """ResNet-50 (stages (3, 4, 6, 3) with ``full``, else one block per
    stage), its random params from ``seed``, the SGD step (under
    ``autotune``, None: the knob) and the data.  Returns (gxm, params,
    step, data)."""
    stages = (3, 4, 6, 3) if full else (1, 1, 1, 1)
    gxm = GxM(resnet50(num_classes, stages=stages), device=device,
              num_classes=num_classes)
    params = gxm.init(torch.Generator().manual_seed(seed))
    step = make_cnn_train_step(gxm, lr=lr, autotune=autotune)
    data = SyntheticImageData(hw=image, n_classes=num_classes,
                              global_batch=batch, seed=seed)
    return gxm, params, step, data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full 50-layer topology (slow on the CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--image", type=int, default=64)
    ap.add_argument("--warmup", action="store_true",
                    help="tune every conv's plan first, then step under "
                         "autotune='cache'")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")

    gxm, params, step, data = build_trainer(
        full=args.full, batch=args.batch, image=args.image,
        device=args.device, autotune="cache" if args.warmup else None)
    if args.warmup:
        report = warmup_cnn_train(gxm, image_hw=(args.image, args.image),
                                  minibatch=args.batch)
        print(f"warmup: {sum(e['cached'] for e in report)} of "
              f"{len(report)} fwd/bwd/wu plan-cache entries")
    etg = gxm.etg
    print(f"ETG: {etg.stats['nodes_before']} ops -> "
          f"{etg.stats['nodes_after']} tasks after fusion; "
          f"{len(etg.kernel_cache)} distinct conv kernels; "
          f"device {gxm.device}")
    losses = []
    for i in range(args.steps):
        params, loss = step(params, data.batch_at(i))
        losses.append(float(loss))
        print(f"step {i:3d}  loss={losses[-1]:.4f}")
    if not all(map(math.isfinite, losses)):
        raise RuntimeError(f"non-finite loss: {losses}")

    # inference with everything fused into conv epilogues (§II-G)
    last = to_device(data.batch_at(args.steps - 1), gxm.device)
    logits = gxm.infer(params, last["image"])
    acc = float((logits.argmax(-1) == last["label"]).float().mean())
    print(f"accuracy on the last batch after {args.steps} steps: {acc:.2f}")
    return losses


if __name__ == "__main__":
    main()
