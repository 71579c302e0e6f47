"""CNN train-step builder, the port's counterpart of the GxM half of
``repro/train/step.py``.

``make_cnn_train_step`` routes every conv through
``core.conv.conv2d_train``: the forward is K1, dI comes from the §II-I
duality (phase-decomposed for strided layers, every dual conv through K1)
and dW from the update-pass kernel K2.  The port has no autotuner yet, so
there is no ``autotune`` argument and no ``warmup_cnn_train``.
"""
from __future__ import annotations

import torch


def to_device(batch: dict, device) -> dict:
    """A {"image", "label"} batch (numpy or tensors) as tensors on
    ``device``: f32 images, int64 labels."""
    return {"image": torch.as_tensor(batch["image"], dtype=torch.float32,
                                     device=device),
            "label": torch.as_tensor(batch["label"], dtype=torch.int64,
                                     device=device)}


def make_cnn_train_step(gxm, *, lr: float = 0.1, bn_momentum: float = 0.9):
    """``step(params, batch) -> (new_params, loss)``: one SGD step of
    ``gxm.sgd_train_step`` on ``gxm``'s device.  The batch may be numpy or
    tensors; ``params`` is left as it was."""
    def step(params, batch):
        return gxm.sgd_train_step(params, to_device(batch, gxm.device), lr,
                                  bn_momentum=bn_momentum)
    return step
