"""Data-parallel CNN training over GxM, the port's counterpart of
``repro/train/distributed.py`` over ``torch.distributed``.

The paper's closing claim is that the JIT-optimized conv kernels fit into
"a lightweight multi-node graph execution model".  This module is the
training half of it: each rank of a process group (the reference's mesh
axis "data") runs the single-device training pipeline (K1 forward, dI by
duality through K1, dW through K2) on its own slice of the batch, and the
only communication between ranks is the gradient reduction between the
weight-update pass and the optimizer, where ``graph/etg.extend_nl`` marks
the backward's reduction point.

Reduction wire format (``REPRO_GRAD_COMPRESS`` / ``grad_compress=``):

  "off"   an exact f32 all-reduce mean (SUM, then / n): with identical
          shards an n-rank step equals the single-device step bit for bit
          where n is a power of two
  "int8"  ``optim.compress.compressed_psum_tree``: error-feedback int8
          codes (summed as int32 on the wire, as in the reference); each
          rank's quantization error lives in the train state
          (``state["residual"]``) and is added to its next gradient.

The state holds the params and the step on every rank, and under "int8"
this rank's row of the group's residual: a ``(1, *shape)`` block of the
reference's ``(n, *shape)`` residual, which its mesh shards over the data
axis.  ``gather_cnn_state`` gathers the rows into the reference's layout
(what a checkpoint holds); ``reshard_cnn_state`` folds a gathered state
onto a group's width (``optim.compress.fold_residual``) and keeps this
rank's row.

Every entry point takes a group (None: the default group) and raises
where ``torch.distributed`` has none (``launch.mesh.require_group``);
nothing runs as one process in silence, and no collective's failure is
caught.  Batches: each rank steps on its own slice of the global batch
(``shard_cnn_batch``, or a data pipeline built with ``n_shards`` and
``shard``).
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

from repro_torch import backend as be
from repro_torch.launch.mesh import data_axis_size, data_rank, require_group
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.optim.compress import compressed_psum_tree, fold_residual
from repro_torch.train.step import to_device


# -- train state -------------------------------------------------------------

def init_cnn_train_state_dp(params, group=None, *,
                            grad_compress: str | None = None) -> dict:
    """The data-parallel train state: the params (the same on every rank)
    and an int32 step, plus under the int8 reduction this rank's row of
    the error-feedback residual, zeros of shape ``(1, *p.shape)`` f32 per
    leaf."""
    compress = be.resolve_grad_compress(grad_compress)
    data_axis_size(group)                          # raises without a group
    first = tree_leaves(params)[0]
    state = {"params": params,
             "step": torch.zeros((), dtype=torch.int32, device=first.device)}
    if compress == "int8":
        state["residual"] = tree_map(
            lambda p: torch.zeros((1, *p.shape), dtype=torch.float32,
                                  device=p.device), params)
    return state


def cnn_state_specs(state) -> dict:
    """Which leaves of a data-parallel CNN state are per rank: the
    reference's PartitionSpecs as tuples, () for a leaf every rank holds
    whole, ("data",) for one split over the group along its first axis
    (the residual)."""
    specs = {"params": tree_map(lambda _: (), state["params"]), "step": ()}
    if "residual" in state:
        specs["residual"] = tree_map(lambda _: ("data",), state["residual"])
    return specs


def gather_cnn_state(state, group=None) -> dict:
    """``state`` with its residual rows gathered over the group into the
    reference's ``(n, *shape)`` layout (a collective: every rank calls
    it); the other leaves as they are.  What a checkpoint holds."""
    group = require_group(group)
    if "residual" not in state:
        return dict(state)
    n = data_axis_size(group)
    leaves = tree_leaves(state["residual"])
    flat = torch.cat([r.reshape(-1) for r in leaves])
    parts = [torch.empty_like(flat) for _ in range(n)]
    dist.all_gather(parts, flat, group=group)
    out, at = [], 0
    for r in leaves:
        size = r.numel()
        out.append(torch.cat([p[at:at + size].reshape(r.shape)
                              for p in parts]))
        at += size
    it = iter(out)
    return dict(state, residual=tree_map(lambda _: next(it),
                                         state["residual"]))


def reshard_cnn_state(state, group=None, *, device=None) -> dict:
    """A whole (gathered or restored) data-parallel state onto ``group``:
    the residual folded to the group's width (``fold_residual``: the sum
    over rows is kept) and this rank's row taken; every leaf on
    ``device`` (None: where it lies)."""
    n = data_axis_size(group)
    rank = data_rank(group)
    move = (lambda t: t) if device is None \
        else (lambda t: torch.as_tensor(t).to(device))
    out = {"params": tree_map(move, state["params"]),
           "step": move(state["step"])}
    if "residual" in state:
        folded = fold_residual(tree_map(torch.as_tensor, state["residual"]),
                               n)
        out["residual"] = tree_map(lambda r: move(r[rank:rank + 1]), folded)
    return out


# -- the step ----------------------------------------------------------------

def cnn_local_grads(gxm, params, batch, *, accum_steps: int = 1):
    """This rank's loss, BN batch statistics and gradient tree on its local
    ``batch`` (tensors on the model's device): ``GxM.local_grads``, the
    first half of the single-device ``GxM.sgd_train_step``.  With
    ``accum_steps`` > 1 the batch splits into that many microbatches along
    its first axis (which must divide) and their losses, statistics and
    gradients are summed from zero in order and divided by
    ``accum_steps``."""
    lead = batch["image"].shape[0]
    if lead % accum_steps:
        raise ValueError(f"local batch {lead} does not divide into "
                         f"{accum_steps} microbatches: examples would be "
                         f"dropped")
    if accum_steps == 1:
        return gxm.local_grads(params, batch)
    m = lead // accum_steps
    loss = stats = grads = None
    for i in range(accum_steps):
        l_, st, g = gxm.local_grads(params, {key: v[i * m:(i + 1) * m]
                                             for key, v in batch.items()})
        if loss is None:
            loss = torch.zeros_like(l_)
            stats = {k: (torch.zeros_like(a), torch.zeros_like(b))
                     for k, (a, b) in st.items()}
            grads = tree_map(torch.zeros_like, g)
        loss = loss + l_
        stats = {k: (stats[k][0] + a, stats[k][1] + b)
                 for k, (a, b) in st.items()}
        grads = tree_map(lambda acc, x: acc + x, grads, g)
    loss = loss / accum_steps
    stats = {k: (a / accum_steps, b / accum_steps)
             for k, (a, b) in stats.items()}
    grads = tree_map(lambda x: x / accum_steps, grads)
    return loss, stats, grads


def allreduce_sum(tensors, group) -> list:
    """The group's sum of each tensor, in one f32 all-reduce SUM over
    their concatenation, each returned in f32."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(t.shape))
        at += t.numel()
    return out


def allreduce_mean(tensors, group) -> list:
    """The group's mean of each tensor: ``allreduce_sum``, then / n, cast
    back to each tensor's dtype."""
    n = float(data_axis_size(group))
    return [(s / n).to(t.dtype)
            for s, t in zip(allreduce_sum(tensors, group), tensors)]


def make_cnn_train_step_dp(gxm, group=None, *, lr: float = 0.1,
                           bn_momentum: float = 0.9, accum_steps: int = 1,
                           grad_compress: str | None = None,
                           autotune: str | None = None,
                           return_grads: bool = False):
    """The data-parallel sibling of ``train.step.make_cnn_train_step``.

    Per rank: the full training pipeline on the rank's local batch (BN on
    local batch statistics, classic data parallelism;
    ``cnn_local_grads``).  Across ranks: one gradient reduction after the
    weight-update pass made the local dW and before the optimizer reads it
    (the exact f32 mean or ``compressed_psum_tree``), and an f32 mean of
    the loss and of the BN statistics.  Then ``GxM.apply_sgd``, the
    single-device step's own update: one SGD step, and the running
    statistics take the mean statistics (``apply_bn_updates``), the same
    on every rank.

    Returns ``step(state, batch) -> (state, {"loss"})``, ``batch`` this
    rank's slice (numpy or tensors; ``shard_cnn_batch``) and ``state``
    from ``init_cnn_train_state_dp``.  ``return_grads`` adds the reduced
    gradient tree ("grads") and this rank's own ("local_grads") to the
    metrics, for checks of the reduction.  ``autotune`` (None: the global
    knob) is the plan mode of every conv launch of the step."""
    group = require_group(group)
    compress = be.resolve_grad_compress(grad_compress)
    if autotune is not None:
        be.resolve_autotune(autotune)               # validate

    def step(state, batch):
        params = state["params"]
        batch = to_device(batch, gxm.device)
        scope = contextlib.nullcontext() if autotune is None \
            else be.use_autotune(autotune)
        with scope:
            loss, stats, grads = cnn_local_grads(gxm, params, batch,
                                                 accum_steps=accum_steps)
        # the GxM reduction point: the local dW exists (the weight-update
        # pass is done) and the optimizer has not run
        names = list(stats)
        if compress == "int8":
            residual = tree_map(lambda r: r[0], state["residual"])
            reduced, residual = compressed_psum_tree(grads, group, residual)
            means = allreduce_mean(
                [loss] + [t for k in names for t in stats[k]], group)
        else:
            g_leaves = tree_leaves(grads)
            means = allreduce_mean(
                g_leaves + [loss] + [t for k in names for t in stats[k]],
                group)
            it = iter(means[:len(g_leaves)])
            reduced = tree_map(lambda _: next(it), grads)
            means = means[len(g_leaves):]
        loss = means[0]
        stats = {k: (means[1 + 2 * i], means[2 + 2 * i])
                 for i, k in enumerate(names)}
        new_state = {"params": gxm.apply_sgd(params, reduced, stats, lr,
                                             bn_momentum=bn_momentum),
                     "step": state["step"] + 1}
        if compress == "int8":
            new_state["residual"] = tree_map(lambda r: r[None], residual)
        metrics = {"loss": loss}
        if return_grads:
            metrics.update(grads=reduced, local_grads=grads)
        return new_state, metrics
    return step


def shard_cnn_batch(batch, group=None) -> dict:
    """This rank's slice of a global ``batch`` (arrays or tensors, batch
    first): rows ``rank * m`` to ``(rank + 1) * m`` of ``m = B / n``; the
    batch must split evenly."""
    n, rank = data_axis_size(group), data_rank(group)
    lead = len(next(iter(batch.values())))
    if lead % n:
        raise ValueError(f"global batch {lead} does not split into {n} "
                         f"ranks")
    m = lead // n
    return {key: v[rank * m:(rank + 1) * m] for key, v in batch.items()}


# -- resilience --------------------------------------------------------------

def restore_latest_dp(ckpt_dir, template, group=None, *, on_skip=None):
    """``checkpoint.restore_latest`` on every rank of ``group``, after a
    barrier that waits for the writer (rank 0, whose loop drained its
    background save before it).  Raises where the ranks restored different
    steps (a rank that cannot see the writer's directory, for one), so
    that no rank goes on from a state its peers do not hold."""
    from repro_torch.train import checkpoint as ckpt_lib
    group = require_group(group)
    dist.barrier(group=group)
    tree, step = ckpt_lib.restore_latest(ckpt_dir, template, on_skip=on_skip)
    steps = [None] * data_axis_size(group)
    dist.all_gather_object(steps, step, group=group)
    if len(set(steps)) != 1:
        raise RuntimeError(
            f"the ranks restored checkpoint steps {steps} from {ckpt_dir!r}: "
            f"every rank must see the writer's checkpoint directory")
    return tree, step


def cnn_dp_resilience(ckpt_dir, group=None, *, device=None) -> dict:
    """The keyword arguments that make ``fault_tolerance.ResilientLoop``
    run the data-parallel CNN state on every rank of ``group`` with its
    checkpoints under ``ckpt_dir``: ``snapshot_fn`` gathers the residual
    over the group at each save point (``gather_cnn_state``), ``writer``
    is rank 0, the only rank that writes checkpoints, ``restore_fn`` walks
    back to the newest checkpoint that restores with the group's width
    (``restore_latest_dp``) and keeps this rank's row
    (``reshard_cnn_state``, on ``device``), and ``group`` makes the loop
    end the run on a failed collective.  Where nothing restores, the state
    stays as it is and the step is 0.  The steps walked past are appended
    to ``restore_fn.skipped`` as (step, error) pairs."""
    group = require_group(group)
    n = data_axis_size(group)

    def template(state):
        out = dict(state)
        if "residual" in state:
            out["residual"] = tree_map(
                lambda r: torch.zeros((n, *r.shape[1:]), dtype=r.dtype,
                                      device=r.device), state["residual"])
        return out

    def restore_fn(state):
        tree, step = restore_latest_dp(
            ckpt_dir, template(state), group,
            on_skip=lambda s, e: restore_fn.skipped.append((s, repr(e))))
        if step == 0:
            return state, 0
        return reshard_cnn_state(tree, group, device=device), step
    restore_fn.skipped = []

    return {"snapshot_fn": lambda state: gather_cnn_state(state, group),
            "writer": data_rank(group) == 0, "restore_fn": restore_fn,
            "group": group}


# -- warmup: tune once, broadcast the entries --------------------------------

def warmup_cnn_train_dp(gxm, group=None, *, global_batch: int,
                        image_hw=(224, 224), mode: str = "tune",
                        backend=None, cache=None, bwd_mode=None):
    """Training warmup for the data-parallel step: rank 0 tunes the "fwd",
    "bwd" and "wu" plan entries once at the per-rank batch
    (``warmup_cnn_train(group=)``) and exports them; the payload reaches
    the other ranks by ``dist.broadcast_object_list``, and they install
    it (``install_warmup_entries``) instead of searching the same space.
    A collective: every rank calls it.  Returns ``(report, payload)`` on
    every rank (the report of the other ranks reads their cache after the
    install)."""
    from repro_torch.train.step import warmup_cnn_train
    from repro_torch.tune.cache import default_cache
    group = require_group(group)
    cache = default_cache() if cache is None else cache
    kw = dict(image_hw=image_hw, minibatch=global_batch, backend=backend,
              cache=cache, bwd_mode=bwd_mode, group=group)
    box = [None]
    if data_rank(group) == 0:
        report = warmup_cnn_train(gxm, mode=mode, **kw)
        box[0] = cache.export_entries([e["key"] for e in report
                                       if e["cached"]])
    dist.broadcast_object_list(box, src=dist.get_global_rank(group, 0),
                               group=group)
    payload = box[0]
    if data_rank(group) != 0:
        install_warmup_entries(payload, cache)
        report = warmup_cnn_train(gxm, mode="cache", **kw)
    return report, payload


def install_warmup_entries(payload, cache=None, *, persist: bool = True):
    """Install a warmup payload another rank broadcast.  Returns the
    number of entries."""
    from repro_torch.tune.cache import default_cache
    cache = default_cache() if cache is None else cache
    return cache.merge_entries(payload, persist=persist)
