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


def composite_roofline(parts: list[dict], *, extra_hbm_bytes: float = 0.0,
                       peak: float = F32_PEAK_FLOPS) -> dict:
    """Roofline of a pipeline of launches, e.g. a chain's band steps: each
    part is a ``tune.measure.conv_traffic`` dict (flops, hbm_bytes, util,
    n_steps); launches serialize, so the cost is the sum of each launch's
    ``kernel_roofline`` cost, plus ``extra_hbm_bytes`` moved between
    launches at the HBM rate.  No per-step term (see
    ``tune.measure``).  ``efficiency`` is the ideal compute time over the
    cost, each summed launch by launch in one order: a launch's ideal time
    is at most its cost (``util`` <= 1) and rounded sums keep that order,
    so it never exceeds 1 (the reference divides the summed flops by the
    peak, which can round above the summed costs)."""
    cost = extra_hbm_bytes / HBM_BYTES_PER_S
    ideal = 0.0
    flops = 0.0
    hbm = extra_hbm_bytes
    steps = 0
    for t in parts:
        cost += kernel_roofline(flops=t["flops"], hbm_bytes=t["hbm_bytes"],
                                util=t.get("util", 1.0), peak=peak)["cost_s"]
        ideal += t["flops"] / peak
        flops += t["flops"]
        hbm += t["hbm_bytes"]
        steps += t.get("n_steps", 0)
    return {
        "cost_s": cost,
        "flops": flops,
        "hbm_bytes": hbm,
        "n_steps": steps,
        "launches": len(parts),
        "efficiency": ideal / cost if cost > 0 else 0.0,
    }


def chain_roofline(chain_t: dict, *, peak: float = F32_PEAK_FLOPS) -> dict:
    """Roofline of a depth-first conv chain from its
    ``tune.measure.chain_traffic`` dict: the fused cost composites the
    band steps (hand-off bands at 0 bytes), the unfused cost the layer
    launches; a chain that fell back has the same two, a speedup of 1."""
    fused = composite_roofline(chain_t["parts"], peak=peak)
    unfused = composite_roofline(chain_t["unfused_parts"], peak=peak)
    cost = fused["cost_s"]
    return {
        "cost_s": cost,
        "unfused_cost_s": unfused["cost_s"],
        "speedup": unfused["cost_s"] / cost if cost > 0 else 0.0,
        "flops": fused["flops"],
        "hbm_bytes": chain_t["hbm_bytes"],
        "unfused_hbm_bytes": chain_t["unfused_hbm_bytes"],
        "intermediate_bytes": chain_t["intermediate_bytes"],
        "launches": fused["launches"],
        "efficiency": fused["efficiency"],
        "fused": chain_t["fused"],
    }
