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
from repro_torch.kernels.matmul_fused import matmul_fused
from repro_torch.kernels.moe_gmm import moe_gmm as moe_grouped_matmul


def matmul(a, b, *, bias=None, act: str = "none", residual=None,
           autotune: str | None = None):
    """K6 under the plan ``core.blocking.matmul_blocking`` gives the shape
    by the autotune mode (``autotune``, else ``REPRO_AUTOTUNE``): under
    "off" the kernel's default plan, exactly ``matmul_fused``; under
    "cache" the cached plan (the default on a miss); under "tune" the
    cached or newly tuned plan, as the reference's ``ops.matmul`` consults
    its ``matmul_blocking`` (``repro/kernels/ops.py:35``)."""
    from repro_torch.core.blocking import matmul_blocking
    plan = matmul_blocking(a.shape[0], b.shape[1], a.shape[1],
                           dtype_bytes=a.element_size(),
                           backend=a.device.type, autotune=autotune)
    return matmul_fused(a, b, bias=bias, act=act, residual=residual,
                        plan=plan)

__all__ = ["attention", "conv1d", "matmul", "moe_grouped_matmul"]
