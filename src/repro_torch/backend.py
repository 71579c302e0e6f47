"""Device resolution for the port.

The reference's ``repro.backend`` selects a kernel implementation
("pallas" / "interpret" / "xla").  Here the tensor's device selects it: a
CPU tensor takes each kernel's plain PyTorch version, a CUDA tensor launches
the hand-written kernel.  What remains to decide is the device itself,
and whether inference runs the int8 path (``REPRO_QUANTIZE``).
"""
from __future__ import annotations

import os

import torch

VALID_QUANTIZE = ("off", "int8")


def get_quantize() -> str:
    """The quantized-inference knob ``REPRO_QUANTIZE``: "off" (default) =
    f32 convs; "int8" = the §II-K serving path (conv tasks marked "q8",
    int8 weights and calibrated activations through K3).  Read at each
    call.  An invalid value raises: the port never runs another path than
    the one asked for."""
    mode = os.environ.get("REPRO_QUANTIZE", "off")
    if mode not in VALID_QUANTIZE:
        raise ValueError(f"REPRO_QUANTIZE={mode!r}; valid: "
                         f"{', '.join(VALID_QUANTIZE)}")
    return mode


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means ``cuda``.

    Raises when no GPU is present and no device was asked for: an entry
    point never drops quietly to the CPU.

    Resolving to a CUDA device turns TF32 off, process-wide, for cuDNN
    convolutions and cuBLAS matmuls.  The reference accumulates in true f32
    (``repro/kernels/ref.py``), but PyTorch lets cuDNN run f32 convolutions
    in TF32 by default, which keeps about three decimal digits; the port's
    oracle (``kernels.ref``) and its glue matmuls (fc) must be true f32
    wherever the port runs on the card."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is present; "
                "pass device='cpu' to run the plain PyTorch versions")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    return device
