"""Device resolution for the port.

The reference's ``repro.backend`` selects a kernel implementation
("pallas" / "interpret" / "xla").  Here the tensor's device selects it: a
CPU tensor takes each kernel's plain PyTorch version, a CUDA tensor launches
the hand-written kernel.  What remains to decide is the device itself.
"""
from __future__ import annotations

import torch


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
