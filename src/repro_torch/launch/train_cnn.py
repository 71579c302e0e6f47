"""ResNet-50 SGD training through GxM on one device, the counterpart of the
single-device path of ``examples/train_resnet50_gxm.py``.

  PYTHONPATH=src python -m repro_torch.launch.train_cnn                  # cuda
  PYTHONPATH=src python -m repro_torch.launch.train_cnn --device cpu --steps 2
  PYTHONPATH=src python -m repro_torch.launch.train_cnn --full --steps 5

Every conv runs ``core.conv.conv2d_train``: the forward through K1, dI by
the §II-I duality through K1, dW through the update-pass kernel K2.  The
weights are random, drawn from seed 0; the batches come from
``data.pipeline.SyntheticImageData``.  Without ``--full`` the topology has
one block per stage.  ``--devices``, ``--compress`` and ``--warmup`` of the
example wait for the data-parallel and autotuner slices.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch.data.pipeline import SyntheticImageData
from repro_torch.graph import GxM, resnet50
from repro_torch.train.step import make_cnn_train_step, to_device


def build_trainer(*, full: bool, num_classes: int = 10, image: int = 64,
                  batch: int = 8, lr: float = 0.05, device=None,
                  seed: int = 0):
    """ResNet-50 (stages (3, 4, 6, 3) with ``full``, else one block per
    stage), its random params from ``seed``, the SGD step and the data.
    Returns (gxm, params, step, data)."""
    stages = (3, 4, 6, 3) if full else (1, 1, 1, 1)
    gxm = GxM(resnet50(num_classes, stages=stages), device=device,
              num_classes=num_classes)
    params = gxm.init(torch.Generator().manual_seed(seed))
    step = make_cnn_train_step(gxm, lr=lr)
    data = SyntheticImageData(hw=image, n_classes=num_classes,
                              global_batch=batch, seed=seed)
    return gxm, params, step, data


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full 50-layer topology (slow on the CPU)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    if args.steps < 1:
        ap.error("--steps must be at least 1")

    gxm, params, step, data = build_trainer(full=args.full, batch=args.batch,
                                            device=args.device)
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
