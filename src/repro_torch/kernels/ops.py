"""One import surface for the LM kernels, the counterpart of
``repro/kernels/ops.py`` (``matmul``, ``conv1d``, ``attention`` and
``moe_grouped_matmul``, :29-73): ``matmul`` is K6's wrapper
``matmul_fused``, ``conv1d`` K8's ``conv1d_causal``, ``attention`` K7's
``flash_attention`` and ``moe_grouped_matmul`` K9's ``moe_gmm``.

The reference picks an implementation with ``impl`` ("xla", "interpret",
"pallas"); here the tensor's device picks it: a CPU tensor takes the
kernel's plain version, a CUDA tensor launches the kernel.  The
reference's "xla" grouped matmul turns ``tile_eid`` into group sizes for
``ref.moe_gmm``; the port's CPU path is ``moe_gmm_plain`` on the stream
itself, which also takes the -1 tiles.

The reference also drops to its XLA oracle whenever the Pallas blocks would
not divide the array (``l % min(l, 128) != 0`` for attention, any of M, N,
K not a multiple of its block for the matmul, D % 8 != 0 for the conv1d;
:36-38, :46 and :56-58), because a Pallas block must divide the array it
cuts.  The port's kernels mask their tails and take every shape, so on the
card there is no such fallback: every attention call is K7, every matmul
call K6, every conv1d call K8 and every grouped matmul K9.
"""
from __future__ import annotations

from repro_torch.kernels.attention import flash_attention as attention
from repro_torch.kernels.conv1d_causal import conv1d_causal as conv1d
from repro_torch.kernels.matmul_fused import matmul_fused as matmul
from repro_torch.kernels.moe_gmm import moe_gmm as moe_grouped_matmul

__all__ = ["attention", "conv1d", "matmul", "moe_grouped_matmul"]
