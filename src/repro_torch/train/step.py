"""CNN train-step builder, the port's counterpart of the GxM half of
``repro/train/step.py``.

``make_cnn_train_step`` routes every conv through
``core.conv.conv2d_train``: the forward is K1, dI comes from the §II-I
duality (phase-decomposed for strided layers, every dual conv through K1)
and dW from the update-pass kernel K2.  ``autotune`` scopes the plan mode
around each step, so a "cache" step takes the plans ``warmup_cnn_train``
tuned (kinds "fwd", "bwd" and "wu") and never tunes inline.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import backend as be


def to_device(batch: dict, device) -> dict:
    """A {"image", "label"} batch (numpy or tensors) as tensors on
    ``device``: f32 images, int64 labels."""
    return {"image": torch.as_tensor(batch["image"], dtype=torch.float32,
                                     device=device),
            "label": torch.as_tensor(batch["label"], dtype=torch.int64,
                                     device=device)}


def make_cnn_train_step(gxm, *, lr: float = 0.1, bn_momentum: float = 0.9,
                        autotune: str | None = None):
    """``step(params, batch) -> (new_params, loss)``: one SGD step of
    ``gxm.sgd_train_step`` on ``gxm``'s device.  The batch may be numpy or
    tensors; ``params`` is left as it was.  ``autotune`` (None: the global
    ``REPRO_AUTOTUNE`` knob) is the plan mode of every conv launch of the
    step, forward and backward."""
    if autotune is not None:
        be.resolve_autotune(autotune)               # validate

    def step(params, batch):
        scope = contextlib.nullcontext() if autotune is None \
            else be.use_autotune(autotune)
        with scope:
            return gxm.sgd_train_step(params, to_device(batch, gxm.device),
                                      lr, bn_momentum=bn_momentum)
    return step


def warmup_cnn_train(gxm, *, image_hw=(224, 224), minibatch: int = 1,
                     mode: str = "tune", backend=None, cache=None,
                     bwd_mode: str | None = None) -> list[dict]:
    """Pre-tune every plan one training step of ``gxm`` at batch
    ``minibatch`` launches: kind "fwd" for each distinct conv, "bwd" for
    the dual conv(s) of its backward-data pass (under ``bwd_mode``, else
    ``REPRO_BWD_DUALITY``) and "wu" for its weight gradient; the training
    counterpart of ``CnnInferenceEngine.warmup``.  ``backend`` None is the
    GxM's device type.  Returns the ``tune.warmup_convs`` report."""
    from repro_torch import tune
    from repro_torch.graph.serving import (conv_shapes,
                                           distinct_conv_signatures)
    sigs = distinct_conv_signatures(conv_shapes(gxm.etg, image_hw))
    return tune.warmup_convs(sigs, minibatches=(minibatch,),
                             kinds=("fwd", "bwd", "wu"), mode=mode,
                             backend=backend or gxm.device.type, cache=cache,
                             bwd_mode=bwd_mode)
