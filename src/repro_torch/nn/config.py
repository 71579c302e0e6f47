"""Model configuration — one frozen dataclass drives every architecture.

The port's own copy of ``repro/nn/config.py``, field for field, so a config
means the same model on both sides.  ``block_pattern`` is the repeating
layer pattern; each entry is ``(mixer, mlp)`` with mixer ∈ {"attn",
"mamba", "rwkv"} and mlp ∈ {"dense", "moe", "rwkv_cm"}.  ``n_layers`` must
be a multiple of the pattern length: params are stacked over pattern
repeats, and the port's decoder loops over them.  ``scan_chunk`` is the
Mamba mixer's chunk of the selective scan.  Fields that steer only the
reference's distributed execution (``remat``, ``fsdp``, ``factored_opt``,
``accum_steps``, ``sharding``) are kept so configs stay identical; the
port's serving path does not read them.

One field is the port's own: ``MoECfg.expert_share`` = (index, count) says
which experts of each MoE layer this device holds, the share
[index·E/count, (index+1)·E/count) that expert parallelism over ``count``
devices gives device ``index`` (the reference's "ep" sharding profile puts
the expert axis on its ``model`` mesh axis).  ``n_experts`` stays the
published E: the router, the capacity and the aux losses are over all E,
and the layer returns the part of its output that the held experts give.
The default (0, 1) holds every expert and means exactly what the
reference's config means.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.25
    expert_share: tuple = (0, 1)  # (index, count): experts held, see above

    def held_experts(self) -> tuple[int, int]:
        """[e0, e1): the experts of ``expert_share``."""
        index, count = self.expert_share
        if count < 1 or not 0 <= index < count or self.n_experts % count:
            raise ValueError(f"expert_share {self.expert_share} does not "
                             f"split {self.n_experts} experts evenly")
        per = self.n_experts // count
        return index * per, (index + 1) * per


@dataclasses.dataclass(frozen=True)
class ModelCfg:
    name: str
    family: str                   # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int | None = None     # default d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False
    moe: MoECfg | None = None
    block_pattern: tuple = (("attn", "dense"),)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    frontend: str | None = None   # "audio" | "vision" stub (see DESIGN.md)
    # mamba
    d_conv: int = 4
    d_state: int = 16
    expand: int = 2
    # execution
    dtype: str = "bfloat16"
    scan_chunk: int = 128         # ssm chunked-scan length
    remat: bool = True
    sub_quadratic: bool = False   # True for ssm/hybrid: long_500k is runnable
    fsdp: bool = False            # ZeRO-3 param sharding over the data axes
    factored_opt: bool = False    # Adafactor-style second moment (100B+ archs)
    accum_steps: int = 1          # gradient-accumulation microbatches
    sharding: str = "tp"          # sharding profile: tp | ddp | ep

    @property
    def head_dim(self) -> int:
        return self.d_head or (self.d_model // self.n_heads)

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def pattern_repeats(self) -> int:
        assert self.n_layers % len(self.block_pattern) == 0, \
            (self.n_layers, len(self.block_pattern))
        return self.n_layers // len(self.block_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings + per-layer)."""
        d, dff, v = self.d_model, self.d_ff, self.vocab
        hd, nh, nkv = self.head_dim, self.n_heads, self.n_kv_heads
        total = v * d * (1 if self.tie_embeddings else 2)
        for mixer, mlp in self.block_pattern:
            reps = self.pattern_repeats
            if mixer == "attn":
                mix = d * (nh * hd) + 2 * d * (nkv * hd) + (nh * hd) * d
            elif mixer == "mamba":
                di, ds = self.d_inner, self.d_state
                mix = d * 2 * di + di * self.d_conv + di * (2 * ds + 2) \
                    + di * d + di * ds
            elif mixer == "rwkv":
                mix = 4 * d * d + d * d  # r,k,v,g(,w lora approx) + out
            else:
                raise ValueError(mixer)
            if mlp == "dense":
                ff = 3 * d * dff
            elif mlp == "moe":
                ff = 3 * d * dff * self.moe.n_experts + d * self.moe.n_experts
            elif mlp == "rwkv_cm":
                ff = 2 * d * dff
            else:
                raise ValueError(mlp)
            total += reps * (mix + ff)
        return total

    def expert_param_count(self) -> int:
        """Parameters living in expert weights (EP-shardable)."""
        if self.moe is None:
            return 0
        moe_layers = sum(1 for _, m in self.block_pattern if m == "moe") \
            * self.pattern_repeats
        return moe_layers * 3 * self.d_model * self.d_ff * self.moe.n_experts

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        d, dff = self.d_model, self.d_ff
        full = self.param_count()
        moe_layers = sum(1 for _, m in self.block_pattern if m == "moe") \
            * self.pattern_repeats
        inactive = moe_layers * 3 * d * dff * (self.moe.n_experts
                                               - self.moe.top_k)
        return full - inactive
