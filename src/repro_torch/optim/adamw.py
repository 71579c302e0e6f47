"""AdamW, the counterpart of ``repro/optim/adamw.py``, with its memory
knobs for the 100B+ archs:

  * ``state_dtype`` — keep m/v in bf16 (halves optimizer memory);
  * ``factored``    — Adafactor-style factored second moment for matrices
    (row + column accumulators, f32, instead of the full v tensor).

The same functional API on the port's trees (nested dicts of tensors, the
reference's layout, so a state converts from the reference's ``opt.init``
with ``convert.params_from_jax``): ``opt.init(params) -> state`` with
``{"mu": {..leaf: {"m", "v"} or {"m", "vr", "vc"}}, "count": int32}``, and
``opt.update(grads, state, params, lr) -> (params, state)``.  Unlike the
reference, ``update`` writes the new params and slots into the tensors it
was given, under ``torch.no_grad()``, and returns the same trees: each
leaf's arithmetic is the reference's, in f32, one leaf at a time, so a
full-width step holds one leaf's f32 temporaries, not a second copy of the
params and the state.  No ``torch.optim``.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

CHUNK = 1 << 24        # values a slice of a large leaf's elementwise update


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts, with the matching leaves of
    ``rest`` (the reference's ``jax.tree.map`` on dict trees)."""
    if isinstance(tree, dict):
        return {key: tree_map(fn, v, *(r[key] for r in rest))
                for key, v in tree.items()}
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in tree_leaves(v)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: torch.dtype = torch.float32
    factored: bool = False
    factored_min_size: int = 128

    def _is_factored(self, p) -> bool:
        return (self.factored and p.dim() >= 2
                and p.shape[-1] >= self.factored_min_size
                and p.shape[-2] >= self.factored_min_size)

    def init(self, params) -> dict:
        def leaf(p):
            m = torch.zeros(p.shape, dtype=self.state_dtype, device=p.device)
            if self._is_factored(p):
                return {"m": m,
                        "vr": torch.zeros(p.shape[:-1], dtype=torch.float32,
                                          device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                          dtype=torch.float32,
                                          device=p.device)}
            return {"m": m, "v": torch.zeros(p.shape, dtype=self.state_dtype,
                                             device=p.device)}
        count = torch.zeros((), dtype=torch.int32,
                            device=tree_leaves(params)[0].device)
        return {"mu": tree_map(leaf, params), "count": count}

    @torch.no_grad()
    def update(self, grads, state, params, lr, *, dims=None, group=None):
        """One AdamW step with bias corrections (the reference's
        ``update``), written into ``params`` and ``state`` in place;
        returns (params, state).

        With ``dims`` (a tree of ints or None beside ``params``) and
        ``group``, each leaf is this rank's slice along its dim of a leaf
        split over the group (``train/fsdp.py``): the elementwise update
        is the same, and the factored second moment's means over a split
        dim are the group's (an all-reduce of the slices' sums)."""
        count = state["count"] + 1
        one = torch.ones((), dtype=torch.float32, device=count.device)
        b1c = 1 - torch.pow(one * self.b1, count.float())
        b2c = 1 - torch.pow(one * self.b2, count.float())
        n = 1 if group is None else dist.get_world_size(group)

        def mean(x, dim, split: bool):
            if not split:
                return x.mean(dim=dim)
            total = x.sum(dim=dim)
            dist.all_reduce(total, group=group)
            return total / (x.shape[dim] * n)

        def dense(g, s_m, s_v, p):
            g32 = g.float()
            m = self.b1 * s_m.float() + (1 - self.b1) * g32
            v = self.b2 * s_v.float() + (1 - self.b2) * g32 * g32
            vhat = v / b2c
            s_v.copy_(v)
            s_m.copy_(m)
            upd = (m / b1c) / (torch.sqrt(vhat) + self.eps)
            upd = upd + self.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)

        def leaf(g, s, p, d=None):
            if "v" in s:
                # elementwise: a large leaf in chunks of CHUNK values, so
                # its f32 temporaries are a chunk's, with the same bits
                parts = (g, s["m"], s["v"], p)
                if p.numel() <= CHUNK or not all(t.is_contiguous()
                                                 for t in parts):
                    return dense(*parts)
                flat = [t.view(-1) for t in parts]
                for at in range(0, p.numel(), CHUNK):
                    dense(*(t[at:at + CHUNK] for t in flat))
                return
            g32 = g.float()
            m = self.b1 * s["m"].float() + (1 - self.b1) * g32
            g2 = g32 * g32
            last, second = g.dim() - 1, g.dim() - 2
            vr = self.b2 * s["vr"] + (1 - self.b2) * mean(
                g2, -1, d == last)
            vc = self.b2 * s["vc"] + (1 - self.b2) * mean(
                g2, -2, d == second)
            # rank-1 reconstruction (Adafactor)
            denom = mean(vr, -1, d == second)[..., None] \
                .clamp_min(1e-30)
            vhat = (vr[..., None] * vc[..., None, :]
                    / denom[..., None]) / b2c
            s["vr"].copy_(vr)
            s["vc"].copy_(vc)
            s["m"].copy_(m)
            upd = (m / b1c) / (torch.sqrt(vhat) + self.eps)
            upd = upd + self.weight_decay * p.float()
            p.copy_(p.float() - lr * upd)

        if dims is None:
            tree_map(leaf, grads, state["mu"], params)
        else:
            tree_map(leaf, grads, state["mu"], params, dims)
        state["count"] = count
        return params, state


def adamw(**kw) -> AdamW:
    return AdamW(**kw)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / |g|), |g|): the global L2 norm in
    f32 over every leaf; the scaled leaves keep their dtypes."""
    gn = torch.sqrt(sum((g.float() ** 2).sum() for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn
