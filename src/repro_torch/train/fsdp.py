"""ZeRO-3 / FSDP storage of the LM train state over the data group: the
port's counterpart of the reference's ``param_rules(fsdp=True)`` under its
pjit step, where GSPMD keeps each parameter and optimizer slot split over
"data" on its "embed" dim and gathers it where a matmul reads it.

Here the placements come from the same tables: the spec tree of the train
state (``train.step.train_state_specs`` of ``nn/transformer.param_specs``)
under ``nn/partitioning.param_rules(fsdp=True)`` on the host mesh
(``launch/mesh.make_host_mesh``), through ``partitioning.to_shardings``,
whose sanitizing leaves a leaf whole where no dim divides.  A leaf placed
over "data" along dim ``d`` is held as its slice ``rank * m`` to
``(rank + 1) * m`` along ``d`` (``m`` = its size / the ranks), copied out
contiguous; "embed" is not always dim 0 (``head`` is ("embed", "vocab"),
block leaves lead with "layers").  A whole leaf is held whole on every
rank.

The step (``train.step.make_train_step(shardings=)``) hands the held slices
to ``transformer.forward`` with ``gatherer``: each leaf is all-gathered
whole where the forward reads it, the top-level leaves once a forward and
one repeat's blocks at the start of that repeat, so under ``cfg.remat``
(whose recompute gathers the repeat again in the backward) a rank holds
one repeat's whole blocks at a time, not the whole model.  The gather is
an autograd op (``_Gather``) whose backward is the reduce-scatter of the
whole leaf's gradient (``reduce_leaf``: its f32 sum over the group, of
which this rank keeps its slice; gloo has no reduce-scatter, so it is an
all-reduce then a slice here on every backend), so each whole gradient
lives only until its leaf's backward is done and the step accumulates
slices.  The clip takes the global norm over the slices with each whole
leaf counted once (``clip_by_global_norm``), and AdamW updates the slices
in place; the factored second moment's means over a split dim are
all-reduced (``optim.adamw.AdamW.update(dims=, group=)``).

Checkpoints keep the reference's layout: rank 0 writes the gathered state
(``gather``), and every rank restores the whole state and keeps its
slices (``shard``); ``resilience`` wires both into
``train.fault_tolerance.ResilientLoop``.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.launch.mesh import data_axis_size, data_rank, require_group
from repro_torch.optim.adamw import tree_leaves, tree_map

AXIS = "data"


def _map(fn, placements, *trees):
    """``fn(leaf, *leaves)`` over a placement (or dims) tree and trees of
    its structure."""
    if not isinstance(placements, dict):
        return fn(placements, *trees)
    return {key: _map(fn, v, *(t[key] for t in trees))
            for key, v in placements.items()}


def state_placements(cfg, opt, mesh) -> dict:
    """The placements of ``cfg``'s train state for ``opt`` on ``mesh``
    (no weight drawn: the state's shapes on the meta device): ZeRO-3 over
    "data" where ``cfg.fsdp``, else every leaf whole.  An optimizer with
    no slots (plain SGD's empty state) has none to place."""
    from repro_torch.nn import transformer as T
    from repro_torch.nn.partitioning import param_rules, to_shardings
    from repro_torch.train.step import train_state_specs
    params = T.init_lm(cfg, device="meta")
    state = {"params": params, "opt": opt.init(params),
             "step": torch.empty((), device="meta")}
    specs = train_state_specs(T.param_specs(cfg), state["opt"]) \
        if state["opt"] else {"params": T.param_specs(cfg), "opt": {},
                              "step": ()}
    return to_shardings(specs, state, param_rules(fsdp=cfg.fsdp, mesh=mesh),
                        mesh)


def dims_of(placements):
    """Per leaf, the dim placed over "data" (None: held whole)."""
    def dim(p):
        for i, axis in enumerate(p):
            if axis == AXIS or (isinstance(axis, tuple) and AXIS in axis):
                return i
        return None
    return _map(dim, placements)


def sharded(placements) -> bool:
    """Whether any leaf is placed over "data"."""
    return any(d is not None for d in tree_leaves(dims_of(placements)))


def _slice(t, d, rank, n):
    m = t.shape[d] // n
    return t.narrow(d, rank * m, m)


def shard(tree, dims, group=None, *, device=None):
    """This rank's slices of a whole tree (params, or a whole, gathered or
    restored train state): each leaf placed over "data" cut to its slice
    along its dim (a contiguous copy, so the whole leaf can be freed), the
    others as they are; on ``device`` (None: where each lies)."""
    def leaf(d, t):
        t = take(torch.as_tensor(t), d, group)
        return t if device is None else t.to(device)
    return _map(leaf, dims, tree)


def take(t, d, group=None):
    """This rank's slice of one whole leaf along ``d`` (None: ``t``), as a
    contiguous copy."""
    if d is None:
        return t
    return _slice(t, d, data_rank(group), data_axis_size(group)).contiguous()


def _wire(t):
    """``t`` as the gloo-supported dtype of the same bytes (an all-gather
    only copies them)."""
    return t.view(torch.float16) if t.dtype == torch.bfloat16 else t


def gather_leaf(t, d, group=None):
    """The whole leaf of this rank's slice ``t`` along ``d``: an all-gather
    over the group, the slices concatenated along ``d`` in rank order;
    ``t`` itself where ``d`` is None."""
    if d is None:
        return t
    group = require_group(group)
    parts = [torch.empty_like(t) for _ in range(data_axis_size(group))]
    dist.all_gather([_wire(p) for p in parts], _wire(t.contiguous()),
                    group=group)
    return torch.cat(parts, dim=d)


def reduce_leaf(g, d, group=None):
    """This rank's slice along ``d`` of the group's f32 sum of the whole
    gradient ``g`` (the reduce-scatter of ``_Gather``'s backward), in
    ``g``'s dtype."""
    s = g.to(torch.float32, copy=True,
             memory_format=torch.contiguous_format)
    dist.all_reduce(s, op=dist.ReduceOp.SUM, group=require_group(group))
    return take(s, d, group).to(g.dtype)


class _Gather(torch.autograd.Function):
    """The whole leaf of a held slice (``gather_leaf``); the gradient of
    the slice is ``reduce_leaf`` of the whole leaf's.  A leaf held whole
    passes through, and its gradient is the group's sum all the same."""

    @staticmethod
    def forward(ctx, t, d, group):
        ctx.d, ctx.group = d, group
        return t.view_as(t) if d is None else gather_leaf(t, d, group)

    @staticmethod
    def backward(ctx, g):
        return reduce_leaf(g, ctx.d, ctx.group), None, None


def gatherer(dims, group=None):
    """``transformer.forward``'s ``gather`` for params held as slices
    placed by ``dims`` (the params' dims tree): ``gather(path, tree)`` is
    the whole leaves of the held subtree at ``path``, through ``_Gather``,
    a block subtree (path ("blocks", pos)) one layer's views without their
    leading "layers" axis."""
    group = require_group(group)

    def gather(path, tree):
        at = dims
        for key in path:
            at = at[key]
        shift = 1 if path[0] == "blocks" else 0

        def leaf(d, t):
            if d is not None and d < shift:
                raise ValueError(f"{path}: a leaf split over its layers "
                                 f"axis cannot be gathered a layer at a "
                                 f"time")
            return _Gather.apply(t, None if d is None else d - shift, group)
        return _map(leaf, at, tree)
    return gather


def gather(tree, dims, group=None):
    """Every leaf of a held tree whole (``gather_leaf``; a collective:
    every rank calls it), detached from the held one: the whole train
    state in the reference's layout, what a checkpoint holds."""
    return _map(lambda d, t: gather_leaf(t.detach(), d, group), dims, tree)


def whole_template(state, dims, group=None):
    """Meta tensors of the whole state's shapes and dtypes (a restore
    template that allocates nothing)."""
    n = data_axis_size(group)

    def leaf(d, t):
        shape = list(t.shape)
        if d is not None:
            shape[d] *= n
        return torch.empty(shape, dtype=t.dtype, device="meta")
    return _map(leaf, dims, state)


def init_state(cfg, opt, placements, generator=None, *, device=None,
               group=None) -> dict:
    """The sharded train state: ``init_lm``'s params drawn whole (every
    rank draws the same), each cut to this rank's slice, and the optimizer
    slots made as zeros of the slices' shapes (their factoring decided on
    the whole shapes, as ``train_state_specs`` reads them)."""
    from repro_torch.nn import transformer as T
    dims = dims_of(placements)
    whole = T.init_lm(cfg, generator, device=device)
    params = shard(whole, dims["params"], group)
    del whole
    for p in tree_leaves(params):
        p.requires_grad_(True)
    device = tree_leaves(params)[0].device
    n = data_axis_size(group)

    def zeros(d, meta):
        shape = list(meta.shape)
        if d is not None:
            shape[d] //= n
        return torch.zeros(shape, dtype=meta.dtype, device=device)
    meta_opt = opt.init(T.init_lm(cfg, device="meta"))
    return {"params": params, "opt": _map(zeros, dims["opt"], meta_opt),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def held_bytes(tree) -> int:
    """Bytes of the tensors ``tree`` holds."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree)
               if isinstance(t, torch.Tensor))


def clip_by_global_norm(grads, dims, max_norm: float, group=None):
    """(grads scaled by min(1, max_norm / |g|), |g|) for this rank's slices
    of a sharded gradient tree: the squares of the sliced leaves are summed
    over the group (one all-reduce), each whole leaf's counted once."""
    g_leaves, d_leaves = tree_leaves(grads), tree_leaves(dims)
    first = g_leaves[0]
    split = torch.zeros((), dtype=torch.float32, device=first.device)
    whole = torch.zeros((), dtype=torch.float32, device=first.device)
    for g, d in zip(g_leaves, d_leaves):
        if d is None:
            whole = whole + (g.float() ** 2).sum()
        else:
            split = split + (g.float() ** 2).sum()
    dist.all_reduce(split, group=require_group(group))
    gn = torch.sqrt(split + whole)
    scale = torch.clamp(max_norm / gn.clamp_min(1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


def resilience(ckpt_dir, dims, group=None, *, device=None) -> dict:
    """The keyword arguments that make ``ResilientLoop`` run a sharded LM
    state on every rank of ``group``: ``snapshot_fn`` gathers the whole
    state at each save point, rank 0 is the only ``writer``, and
    ``restore_fn`` walks back to the newest checkpoint that restores
    (``distributed.restore_latest_dp``, the whole state read to the host)
    and keeps this rank's slices on ``device`` (None: the held state's).
    Where nothing restores, the state stays as it is and the step is 0."""
    from repro_torch.train.distributed import restore_latest_dp
    group = require_group(group)

    def restore_fn(state):
        tree, step = restore_latest_dp(
            ckpt_dir, whole_template(state, dims, group), group,
            device="cpu")
        if step == 0:
            return state, 0
        at = device or tree_leaves(state["params"])[0].device
        out = shard(tree, dims, group, device=at)
        for p in tree_leaves(out["params"]):
            p.requires_grad_(True)
        return out, step

    return {"snapshot_fn": lambda state: gather(state, dims, group),
            "writer": data_rank(group) == 0, "restore_fn": restore_fn,
            "group": group}
