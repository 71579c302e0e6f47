"""The H100's roofline: one set of peak rates for the tuner's cost model
(``repro_torch.tune.measure``) and for the bounds ``chip_smoke.py``
reports beside every kernel time.

Published peaks of one H100 SXM at its full 700 W limit (NVIDIA's data
sheet, dense, no sparsity): f32 on the SIMT cores (no tensor cores, which
is what most of the port's f32 kernels use), TF32, bf16 and int8 on the
tensor cores, HBM3.  K2's mma route computes each f32 product as three
TF32 ones (the 3xTF32 split), so its bound is 3 x its FLOPs at the TF32
rate.  A bf16 function is bound by the bf16 tensor-core rate even where
the port's kernel widens bf16 to f32 on the SIMT cores: the bound is what
the card could do, not what the kernel does.  A
card set below 700 W runs slower; the records state its limit beside every
number.
"""
from __future__ import annotations

F32_PEAK_FLOPS = 67e12      # f32 FMA outside the tensor cores
TF32_PEAK_FLOPS = 494.7e12  # dense TF32 tensor cores
BF16_PEAK_FLOPS = 989e12    # dense bf16 tensor cores
INT8_PEAK_OPS = 1979e12     # dense int8 tensor cores
HBM_BYTES_PER_S = 3.35e12   # HBM3
SMS = 132                   # streaming multiprocessors


def bound_ms(ops: float, nbytes: float,
             peak: float = F32_PEAK_FLOPS) -> tuple[float, str]:
    """The least time the card could take, in ms, for ``ops`` operations
    at ``peak`` and ``nbytes`` moved through HBM, and which of the two
    bounds it ("operations" or "bytes")."""
    t_ops = ops / peak * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def kernel_roofline(*, flops: float, hbm_bytes: float, util: float = 1.0,
                    peak: float = F32_PEAK_FLOPS) -> dict:
    """Roofline terms of one kernel launch: compute time at ``peak`` scaled
    by the kernel's occupancy ``util`` (the share of the lanes it runs that
    do real work), memory time at HBM rate, and the larger of the two.
    ``efficiency`` is ideal compute time over that."""
    t_comp = flops / (peak * max(util, 1e-3))
    t_mem = hbm_bytes / HBM_BYTES_PER_S
    cost = max(t_comp, t_mem)
    return {
        "compute_s": t_comp,
        "memory_s": t_mem,
        "cost_s": cost,
        "dominant": "compute" if t_comp >= t_mem else "memory",
        "efficiency": flops / peak / cost if cost > 0 else 0.0,
    }
