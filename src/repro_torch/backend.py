"""Device resolution for the port.

The reference's ``repro.backend`` selects a kernel implementation
("pallas" / "interpret" / "xla").  Here the tensor's device selects it: a
CPU tensor takes each kernel's plain PyTorch version, a CUDA tensor launches
the hand-written kernel.  What remains to decide is the device itself,
whether inference runs the int8 path (``REPRO_QUANTIZE``), where
blockings come from (``REPRO_AUTOTUNE``), which input strategy the
conv kernels take (``REPRO_CONV_TILING``), whether inference runs
conv->conv chains depth-first (``REPRO_CHAIN_FUSION``), and the wire
format of the data-parallel gradient reduction (``REPRO_GRAD_COMPRESS``).
"""
from __future__ import annotations

import os
from contextlib import contextmanager

import torch

VALID_QUANTIZE = ("off", "int8")
VALID_AUTOTUNE = ("off", "cache", "tune")
VALID_CONV_TILING = ("tiled", "whole")
VALID_CHAIN_FUSION = ("off", "on")
VALID_GRAD_COMPRESS = ("off", "int8")
_autotune: str | None = None     # set_autotune's value; None reads the env
_conv_tiling: str | None = None  # set_conv_tiling's value; None reads the env
_chain_fusion: str | None = None  # set_chain_fusion's value; None: the env
_grad_compress: str | None = None  # set_grad_compress's value; None: the env


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


def _valid_autotune(mode: str, source: str) -> str:
    if mode not in VALID_AUTOTUNE:
        raise ValueError(f"{source}={mode!r}; valid: "
                         f"{', '.join(VALID_AUTOTUNE)}")
    return mode


def get_autotune() -> str:
    """The blocking-autotune knob (§II-D): "off" (default) = the analytic
    blocking of ``core.blocking``; "cache" = the persistent per-shape
    cache of ``repro_torch.tune``, analytic on a miss; "tune" = on a miss,
    search the space, time the shortlist on the card, persist the winner.
    ``set_autotune`` overrides ``REPRO_AUTOTUNE``, which is read at each
    call otherwise.  An invalid value raises."""
    if _autotune is not None:
        return _autotune
    return _valid_autotune(os.environ.get("REPRO_AUTOTUNE", "off"),
                           "REPRO_AUTOTUNE")


def set_autotune(mode: str) -> None:
    """Pin the autotune mode for this process, over ``REPRO_AUTOTUNE``."""
    global _autotune
    _autotune = _valid_autotune(mode, "autotune")


@contextmanager
def use_autotune(mode: str):
    global _autotune
    prev = _autotune
    set_autotune(mode)
    try:
        yield
    finally:
        _autotune = prev


def resolve_autotune(mode: str | None) -> str:
    """``mode`` if given (validated), else ``get_autotune()``."""
    return get_autotune() if mode is None else _valid_autotune(mode,
                                                                "autotune")


def _valid_conv_tiling(mode: str, source: str) -> str:
    if mode not in VALID_CONV_TILING:
        raise ValueError(f"{source}={mode!r}; valid: "
                         f"{', '.join(VALID_CONV_TILING)}")
    return mode


def get_conv_tiling() -> str:
    """The conv input-strategy knob: "tiled" (default) = K1, K2 and K3,
    which stage only the input rows each tile reads; "whole" = the
    reference's legacy whole-plane kernels K10a, K10b and K10c (one block
    per output block over the resident padded plane; K10b's blocks each
    take a run of the plane's row steps), kept for A/B measurement.  ``set_conv_tiling`` overrides ``REPRO_CONV_TILING``,
    which is read at each call otherwise.  An invalid value raises: the
    port never runs another path than the one asked for."""
    if _conv_tiling is not None:
        return _conv_tiling
    return _valid_conv_tiling(os.environ.get("REPRO_CONV_TILING", "tiled"),
                              "REPRO_CONV_TILING")


def set_conv_tiling(mode: str) -> None:
    """Pin the conv input strategy for this process, over
    ``REPRO_CONV_TILING``."""
    global _conv_tiling
    _conv_tiling = _valid_conv_tiling(mode, "conv_tiling")


@contextmanager
def use_conv_tiling(mode: str):
    global _conv_tiling
    prev = _conv_tiling
    set_conv_tiling(mode)
    try:
        yield
    finally:
        _conv_tiling = prev


def _valid_chain_fusion(mode: str, source: str) -> str:
    if mode not in VALID_CHAIN_FUSION:
        raise ValueError(f"{source}={mode!r}; valid: "
                         f"{', '.join(VALID_CHAIN_FUSION)}")
    return mode


def get_chain_fusion() -> str:
    """Depth-first chain fusion: "off" (default) = every conv task runs
    layer by layer; "on" = the GxM inference forward runs each detected
    single-consumer conv->conv chain band by band
    (``kernels.conv2d_chain``), falling back per chain to layer by layer
    where the band does not fit the chain budget or fusion is not
    profitable (``tune.measure.chain_traffic``).  ``set_chain_fusion``
    overrides ``REPRO_CHAIN_FUSION``, which is read at each call
    otherwise.  An invalid value raises."""
    if _chain_fusion is not None:
        return _chain_fusion
    return _valid_chain_fusion(os.environ.get("REPRO_CHAIN_FUSION", "off"),
                               "REPRO_CHAIN_FUSION")


def set_chain_fusion(mode: str) -> None:
    """Pin chain fusion for this process, over ``REPRO_CHAIN_FUSION``."""
    global _chain_fusion
    _chain_fusion = _valid_chain_fusion(mode, "chain_fusion")


@contextmanager
def use_chain_fusion(mode: str):
    global _chain_fusion
    prev = _chain_fusion
    set_chain_fusion(mode)
    try:
        yield
    finally:
        _chain_fusion = prev


def _valid_grad_compress(mode: str, source: str) -> str:
    if mode not in VALID_GRAD_COMPRESS:
        raise ValueError(f"{source}={mode!r}; valid: "
                         f"{', '.join(VALID_GRAD_COMPRESS)}")
    return mode


def get_grad_compress() -> str:
    """The data-parallel gradient reduction's wire format: "off" (default)
    = an exact f32 all-reduce mean; "int8" = the error-feedback compressed
    reduction of ``optim.compress`` (a residual carried in the train
    state; see ``train.distributed``).  ``set_grad_compress`` overrides
    ``REPRO_GRAD_COMPRESS``, which is read at each call otherwise.  An
    invalid value raises."""
    if _grad_compress is not None:
        return _grad_compress
    return _valid_grad_compress(os.environ.get("REPRO_GRAD_COMPRESS", "off"),
                                "REPRO_GRAD_COMPRESS")


def set_grad_compress(mode: str) -> None:
    """Pin the reduction's wire format for this process, over
    ``REPRO_GRAD_COMPRESS``."""
    global _grad_compress
    _grad_compress = _valid_grad_compress(mode, "grad_compress")


@contextmanager
def use_grad_compress(mode: str):
    global _grad_compress
    prev = _grad_compress
    set_grad_compress(mode)
    try:
        yield
    finally:
        _grad_compress = prev


def resolve_grad_compress(mode: str | None) -> str:
    """``mode`` if given (validated), else ``get_grad_compress()``."""
    return get_grad_compress() if mode is None \
        else _valid_grad_compress(mode, "grad_compress")


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
