"""Train / prefill / decode step builders, the port's counterpart of
``repro/train/step.py``, on one device.

``make_train_step`` is the LM step: the loss (``transformer.lm_loss``, or
``lm_loss_embeds`` for a batch with "embeds") and its gradients by
autograd, the reference's ``jax.value_and_grad``, over ``accum_steps``
microbatches summed in f32; the global-norm clip; the optimizer.  On the
card every attention forward is K7 and its gradient K7's backward kernel,
every Mamba conv1d K8 with K8' as its gradient and every MoE grouped
matmul K9 with K9'.  With ``group`` (a ``torch.distributed`` process group,
``launch.mesh``) the step is data-parallel: each rank takes its slice of
the batch, and the loss and gradients are those of the group's batch (the
mean over every unmasked label, the MoE router statistics over every
token; one f32 all-reduce) before the clip and the optimizer, so every
rank applies the same update.  With ``shardings`` each rank holds only
its slices of the params and the optimizer slots (ZeRO-3 over "data",
``train/fsdp.py``), placed by ``train_state_specs``, the reference's spec
tree of the train state: the forward gathers each leaf where it reads it,
and the backward reduce-scatters its gradient.

``make_cnn_train_step`` routes every conv through
``core.conv.conv2d_train``: the forward is K1, dI comes from the §II-I
duality (phase-decomposed for strided layers, every dual conv through K1)
and dW from the update-pass kernel K2.  ``autotune`` scopes the plan mode
around each step, so a "cache" step takes the plans ``warmup_cnn_train``
tuned (kinds "fwd", "bwd" and "wu") and never tunes inline.
"""
from __future__ import annotations

import contextlib

import torch

from repro_torch import backend as be
from repro_torch.nn import moe
from repro_torch.nn import transformer as T
from repro_torch.nn.common import softmax_xent
from repro_torch.optim.adamw import clip_by_global_norm, tree_leaves, \
    tree_map


def lm_batch(batch: dict, device) -> dict:
    """An LM batch (numpy or tensors) on ``device``: "tokens" and "labels"
    as int64, "embeds" as they are."""
    return {key: torch.as_tensor(v, device=device,
                                 dtype=None if key == "embeds"
                                 else torch.int64)
            for key, v in batch.items()}


def loss_parts(params, cfg, batch, gather=None):
    """(the mean cross-entropy, the MoE aux loss) of ``batch``: the two
    terms of ``transformer.lm_loss`` (``lm_loss_embeds`` for a batch with
    "embeds"); ``gather`` is ``transformer.forward``'s."""
    key = "embeds" if "embeds" in batch else "tokens"
    logits, aux = T.forward(params, cfg, gather=gather,
                            **{key: batch[key]})
    return softmax_xent(logits, batch["labels"]), aux


def loss_for_batch(params, cfg, batch):
    xent, aux = loss_parts(params, cfg, batch)
    return xent + aux


def make_train_step(cfg, opt, *, lr: float = 3e-4, clip: float = 1.0,
                    accum_steps: int = 1, group=None, shardings=None):
    """``train_step(state, batch) -> (state, {"loss", "grad_norm"})`` on
    the params' device.  With ``accum_steps`` > 1 the batch splits into
    that many microbatches along its first axis, whose gradients are summed
    in f32 and divided by ``accum_steps``, as is the loss.  The optimizer
    returns the new params and slots (AdamW writes them in place); the
    step counter advances.  A leaf the loss does not reach raises, save
    the token table under "embeds", whose gradient is zero as the
    reference's is.

    With ``group`` (an initialised process group, the host mesh's
    ``get_group("data")``; None here means no data parallelism, not the
    default group) the batch is this rank's slice, and the loss and
    gradients are those of the whole group's batch, as the reference's
    step under a mesh takes them: each rank's microbatch i contributes its
    cross-entropy weighted by its share of the group's unmasked labels in
    microbatch i (one all-reduce of the counts), plus its share of the MoE
    aux loss, whose router statistics are the group's
    (``nn.moe.data_group``), each divided by ``accum_steps``; autograd
    differentiates that sum, and an f32 all-reduce SUM
    (``distributed.allreduce_sum``, in place, bucket by bucket) adds the
    ranks' gradients and losses before the global-norm clip.  An MoE
    config whose devices hold a share of the experts
    (``MoECfg.expert_share``) raises under ``group``.

    ``shardings`` (the train state's placements,
    ``train.fsdp.state_placements``; needs ``group``) makes the step
    ZeRO-3: ``state`` holds this rank's slices (``train.fsdp.init_state``),
    each gathered whole where the forward reads it (``fsdp.gatherer``: a
    repeat's blocks within that repeat, again in its remat's recompute);
    the backward reduce-scatters each whole gradient as it is done, so the
    step sums slices of the group's gradients and only the loss is
    all-reduced after it; the clip's norm is the group's, and AdamW
    updates the slices in place."""
    dims = gather = None
    if group is not None:
        from repro_torch.launch.mesh import require_group
        from repro_torch.train import distributed as D
        require_group(group)
        if cfg.moe is not None and \
                tuple(cfg.moe.expert_share) != (0, 1):
            raise ValueError(
                f"{cfg.name}: data-parallel training with a share of the "
                f"experts per device (expert_share {cfg.moe.expert_share}) "
                f"is expert parallelism, which waits for the port's "
                f"tensor-parallel slice")
    if shardings is not None:
        from repro_torch.train import fsdp
        if group is None:
            raise ValueError("shardings without a group: ZeRO-3 storage "
                             "splits the state over a data group")
        dims = fsdp.dims_of(shardings)["params"]
        gather = fsdp.gatherer(dims, group)

    def grads_of(params, leaves, batch, weight=None):
        """The loss and its gradients; under ``group`` the loss is
        ``weight`` x the cross-entropy + the aux loss / ``accum_steps``, and
        the group's router statistics hold through the backward too (a
        remat recompute runs the layer again there)."""
        if weight is None:
            loss = loss_for_batch(params, cfg, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        else:
            with moe.data_group(group):
                xent, aux = loss_parts(params, cfg, batch, gather)
                loss = weight * xent + aux / accum_steps
                grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        out = []
        for p, g in zip(leaves, grads):
            if g is None:
                if not ("embeds" in batch and p is params["embed"]):
                    raise RuntimeError(
                        f"no gradient reached a param of shape "
                        f"{tuple(p.shape)}: a kernel on its path has no "
                        f"backward")
                g = torch.zeros_like(p)
            out.append(g)
        return loss.detach(), out

    def weights(batch):
        """Under ``group``: each microbatch's weight, this rank's unmasked
        labels there over the group's, / ``accum_steps``."""
        counts = torch.stack([(lab >= 0).sum() for lab in
                              batch["labels"].chunk(accum_steps)]).float()
        total = D.allreduce_sum([counts.clone()], group)[0]
        return counts / total.clamp_min(1.0) / accum_steps

    def train_step(state, batch):
        params = state["params"]
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        batch = lm_batch(batch, leaves[0].device)
        w = None if group is None else weights(batch)
        with torch.enable_grad():
            if accum_steps == 1 and w is None:
                loss, grads = grads_of(params, leaves, batch)
            elif accum_steps == 1 and dims is not None:
                # ZeRO-3 in one pass: its backward reduced each gradient,
                # the loss is left
                loss, grads = grads_of(params, leaves, batch, w[0])
                loss = D.allreduce_sum([loss.float()[None]], group)[0]
            else:
                acc = [torch.zeros(p.shape, dtype=torch.float32,
                                   device=p.device) for p in leaves]
                loss = torch.zeros((), dtype=torch.float32,
                                   device=leaves[0].device)
                for i in range(accum_steps):
                    micro = {key: v.chunk(accum_steps)[i]
                             for key, v in batch.items()}
                    l, g = grads_of(params, leaves, micro,
                                    None if w is None else w[i])
                    for a, gi in zip(acc, g):
                        a.add_(gi)
                    del g
                    loss = loss + l
                if w is None:
                    grads = [a / accum_steps for a in acc]
                    loss = loss / accum_steps
                else:
                    # the data-parallel reduction point: every rank's
                    # gradients are in (under ZeRO-3 each was reduced in
                    # its backward, and the loss is left), the clip and
                    # the optimizer have not run
                    loss = loss[None]
                    D.allreduce_sum((acc if dims is None else []) + [loss],
                                    group)
                    loss = loss[0]
                    grads = [a.to(p.dtype) for a, p in zip(acc, leaves)]
                    del acc
        del leaves
        it = iter(grads)
        grads = tree_map(lambda _: next(it), params)
        if dims is None:
            grads, gnorm = clip_by_global_norm(grads, clip)
        else:
            grads, gnorm = fsdp.clip_by_global_norm(grads, dims, clip, group)
        state["params"], state["opt"] = opt.update(
            grads, state["opt"], params, lr,
            **({} if dims is None else {"dims": dims, "group": group}))
        state["step"] = state["step"] + 1
        return state, {"loss": loss, "grad_norm": gnorm}
    train_step.shardings = shardings
    return train_step


def make_prefill_step(cfg, *, cache_len: int):
    """``prefill(params, batch) -> (last logits (B,1,V), decode cache)``."""
    def prefill(params, batch):
        key = "embeds" if "embeds" in batch else "tokens"
        logits, _, cache = T.forward(params, cfg, **{key: batch[key]},
                                     return_cache=True, cache_len=cache_len)
        return logits[:, -1:, :], cache
    return prefill


def make_decode_step(cfg):
    """``serve_step(params, tokens, cache, idx) -> (logits, cache)``."""
    def serve_step(params, tokens, cache, idx):
        return T.decode_step(params, cfg, tokens, cache, idx)
    return serve_step


def init_train_state(cfg, opt, generator: torch.Generator | None = None, *,
                     device=None) -> dict:
    """``{"params", "opt", "step"}``: ``transformer.init_lm``'s params (each
    a leaf that requires grad), ``opt.init`` of them and an int32 step 0.
    The reference also returns the params' spec tree, which is
    ``transformer.param_specs(cfg)`` here."""
    params = T.init_lm(cfg, generator, device=device)
    for p in tree_leaves(params):
        p.requires_grad_(True)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["embed"].device)}


def train_state_specs(param_specs, opt_state) -> dict:
    """Logical-axis spec tree for the full train state
    (``repro/train/step.py:149-168``): optimizer slots inherit their
    parameter's axes, the factored accumulators drop the reduced dim ("vr"
    the last, "vc" the second-last).  Only ``opt_state``'s structure is
    read."""
    def slots(spec, slot):
        if isinstance(spec, dict):
            return {key: slots(v, slot[key]) for key, v in spec.items()}
        out = {"m": spec}
        if "v" in slot:
            out["v"] = spec
        if "vr" in slot:
            out["vr"] = spec[:-1]
            out["vc"] = spec[:-2] + spec[-1:]
        return out
    return {"params": param_specs,
            "opt": {"mu": slots(param_specs, opt_state["mu"]), "count": ()},
            "step": ()}


def to_device(batch: dict, device) -> dict:
    """A {"image", "label"} batch (numpy or tensors) as tensors on
    ``device``: f32 images, int64 labels."""
    return {"image": torch.as_tensor(batch["image"], dtype=torch.float32,
                                     device=device),
            "label": torch.as_tensor(batch["label"], dtype=torch.int64,
                                     device=device)}


def make_cnn_train_step(gxm, *, lr: float = 0.1, bn_momentum: float = 0.9,
                        autotune: str | None = None):
    """``step(params, batch) -> (new_params, loss)``: one SGD step of
    ``gxm.sgd_train_step`` on ``gxm``'s device.  The batch may be numpy or
    tensors; ``params`` is left as it was.  ``autotune`` (None: the global
    ``REPRO_AUTOTUNE`` knob) is the plan mode of every conv launch of the
    step, forward and backward."""
    if autotune is not None:
        be.resolve_autotune(autotune)               # validate

    def step(params, batch):
        scope = contextlib.nullcontext() if autotune is None \
            else be.use_autotune(autotune)
        with scope:
            return gxm.sgd_train_step(params, to_device(batch, gxm.device),
                                      lr, bn_momentum=bn_momentum)
    return step


def warmup_cnn_train(gxm, *, image_hw=(224, 224), minibatch: int = 1,
                     mode: str = "tune", backend=None, cache=None,
                     bwd_mode: str | None = None, group=None) -> list[dict]:
    """Pre-tune every plan one training step of ``gxm`` at batch
    ``minibatch`` launches: kind "fwd" for each distinct conv, "bwd" for
    the dual conv(s) of its backward-data pass (under ``bwd_mode``, else
    ``REPRO_BWD_DUALITY``) and "wu" for its weight gradient, or under
    ``REPRO_CONV_TILING=whole`` the whole-plane blockings of "fwd_whole",
    "bwd_whole" and "wu_whole"; the training counterpart of
    ``CnnInferenceEngine.warmup``.  ``backend`` None is the GxM's device
    type.  With ``group`` (the reference's ``mesh=``), ``minibatch`` is
    the global batch and the entries are keyed at the per-rank batch the
    data-parallel step runs (``train.distributed.warmup_cnn_train_dp``
    adds the broadcast).  Returns the ``tune.warmup_convs`` report."""
    from repro_torch import tune
    from repro_torch.graph.serving import (conv_shapes,
                                           distinct_conv_signatures)
    if group is not None:
        from repro_torch.launch.mesh import data_axis_size
        ranks = data_axis_size(group)
        if minibatch % ranks:
            raise ValueError(f"global batch {minibatch} does not split into "
                             f"{ranks} ranks")
        minibatch //= ranks
    sigs = distinct_conv_signatures(conv_shapes(gxm.etg, image_hw))
    kinds = ("fwd", "bwd", "wu")
    if be.get_conv_tiling() == "whole":
        kinds = tuple(f"{kind}_whole" for kind in kinds)
    return tune.warmup_convs(sigs, minibatches=(minibatch,),
                             kinds=kinds, mode=mode,
                             backend=backend or gxm.device.type, cache=cache,
                             bwd_mode=bwd_mode)
