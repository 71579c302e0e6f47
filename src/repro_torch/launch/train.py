"""LM trainer, the counterpart of ``repro/launch/train.py``: model init ->
train step (AdamW, the global-norm clip, ``accum_steps`` microbatches) ->
the resilient loop (async checkpoints, walk-back restore on failure,
optional seeded chaos) -> metrics.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --smoke --steps 20 --device cpu
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b --steps 5 --seq-len 512

On the card every attention forward is K7 and its gradient K7's backward
kernel (``kernels/attention.flash_attention_bwd``), every Mamba conv1d K8
with K8' (``kernels/conv1d_causal.conv1d_causal_bwd``) and every MoE
grouped matmul K9 with K9' (``kernels/moe_gmm.moe_gmm_bwd``), so hybrid
and MoE archs train there too; Jamba-1.5-Large trains on one card as
``jamba-1.5-large-398b-train-1chip`` (two layers at the published widths,
4 of 16 experts held):

  PYTHONPATH=src python -m repro_torch.launch.train --arch jamba-1.5-large-398b-train-1chip --steps 3 --seq-len 512 --global-batch 2

Data parallelism: under ``torchrun`` (its environment: ``RANK``,
``WORLD_SIZE``, ...) the trainer builds the reference's host mesh over
every rank (``launch.mesh.make_host_mesh``, axes "data" x "model" of 1),
each rank on ``cuda:LOCAL_RANK`` with its slice of the global batch, and
the step reduces the gradients and the loss over the data group before
the clip (``train.step.make_train_step(group=)``); MoE configs take their
router statistics over the group.  A ``cfg.fsdp`` config (``qwen3-8b``,
``phi3.5-moe-42b-a6.6b``, ``jamba-1.5-large-398b``, ``dbrx-132b``) trains
ZeRO-3 there: each rank holds its slices of the params and optimizer
slots as ``param_rules(fsdp=True)`` places them (``train/fsdp.py``), and
the summary gives each rank's held bytes beside the whole state's.
Outside ``torchrun`` the trainer runs on one device.

  torchrun --nproc-per-node 2 -m repro_torch.launch.train --arch qwen3-8b --smoke --steps 4 --device cpu

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-1.5b --steps 20 --ckpt-dir ckpt --ckpt-every 5 --chaos-seed 3

Checkpoints go to ``--ckpt-dir`` every ``--ckpt-every`` steps, and a run
resumes from the newest checkpoint there that restores.  Rank 0 writes
them and every rank restores from them, so under ``torchrun`` on more than
one host ``--ckpt-dir`` must name storage every rank sees (a rank that
restores another step than its peers raises).  Without ``--ckpt-dir``,
rank 0 makes a temporary directory, tells the other ranks its path, and
removes it at the end.  ``--chaos-seed`` (or ``REPRO_CHAOS=<seed>``)
replays a seeded fault schedule (``train/chaos.py``) against
``--chaos-hosts`` simulated hosts; under ``torchrun`` every rank replays
the same schedule, and a failure that is not one of its injected faults
(a failed collective) ends the run instead of being retried.  The summary
carries ``params_crc32``, a CRC32 of the final params' bytes, and under
``torchrun`` ``ranks_agree``: whether every rank's is the same.

The weights are random, drawn from seed 0 (``build(seed=)``); batches come
from ``data.pipeline.make_pipeline`` (synthetic tokens, or
``--data-path``).  The reference's ``--production-mesh`` and
``--model-parallel`` need tensor parallelism over "model", which waits for
the port's tensor-parallel slice (ROADMAP Queue 1): argparse refuses them.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
import zlib

import torch

from repro_torch.configs import get_config, list_archs, smoke_config
from repro_torch.data import make_pipeline
from repro_torch.launch import mesh
from repro_torch.launch.serve import _sync
from repro_torch.optim.adamw import AdamW, tree_leaves
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault_tolerance import ResilientLoop
from repro_torch.train.step import init_train_state, make_train_step


def build(cfg, *, lr: float = 3e-4, accum_steps: int = 1, seed: int = 0,
          device=None, group=None, mesh=None):
    """AdamW (the reference's: factored bf16 state for ``cfg.factored_opt``,
    else f32), the train state with random params from ``seed`` on
    ``device`` (default cuda; every rank draws the same) and the train
    step, data-parallel over ``group``, or over ``mesh``'s data group
    (``launch.mesh.make_host_mesh``), where one is given.  Under a mesh a
    ``cfg.fsdp`` config is ZeRO-3: the state holds this rank's slices
    (``train.fsdp``) and the step's ``shardings`` are their placements (the
    reference's ``build`` takes ``to_shardings`` of the state's specs under
    ``param_rules`` the same way).  Returns (state, step)."""
    from repro_torch.backend import resolve_device
    from repro_torch.train import fsdp
    opt = AdamW(factored=cfg.factored_opt,
                state_dtype=(torch.bfloat16 if cfg.factored_opt
                             else torch.float32))
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(seed)
    placements = None
    if mesh is not None:
        group = mesh.get_group("data")
        placements = fsdp.state_placements(cfg, opt, mesh)
        if not fsdp.sharded(placements):
            placements = None
    if placements is None:
        state = init_train_state(cfg, opt, generator, device=device)
    else:
        state = fsdp.init_state(cfg, opt, placements, generator,
                                device=device, group=group)
    return state, make_train_step(cfg, opt, lr=lr, accum_steps=accum_steps,
                                  group=group, shardings=placements)


def main(argv=None, *, group=None) -> dict:
    """Parse ``argv``, train, and return the summary.  ``group`` is an
    initialised default group the caller owns (a process of
    ``launch.ranks.run_ranks``, say); without one, under ``torchrun``
    the default group is made here and destroyed at the end.  The host
    mesh is built over the group's ranks."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="smollm-360m")
    ap.add_argument("--smoke", action="store_true",
                    help="the arch's reduced config (tiny widths, f32)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--accum-steps", type=int, default=1)
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda, or cuda:LOCAL_RANK "
                         "under torchrun; raises without a GPU)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, which every rank must see "
                         "(default: a temporary one rank 0 makes, removed at "
                         "the end)")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--chaos-seed", type=int,
                    default=(int(os.environ["REPRO_CHAOS"])
                             if os.environ.get("REPRO_CHAOS") else None),
                    help="inject a seeded fault schedule (train/chaos.py) "
                         "against a simulated fleet of --chaos-hosts; also "
                         "REPRO_CHAOS=<seed>")
    ap.add_argument("--chaos-hosts", type=int, default=4)
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's 16 x 16 mesh: refused (tensor "
                         "parallelism)")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="the model axis: only 1 (tensor parallelism is "
                         "refused)")
    args = ap.parse_args(argv)
    if args.production_mesh or args.model_parallel != 1:
        ap.error("--production-mesh and --model-parallel > 1 shard the "
                 "params over a \"model\" axis by tensor parallelism, which "
                 "waits for the port's tensor-parallel slice (ROADMAP Queue "
                 "1); data parallelism and ZeRO-3 run under torchrun")

    own = group is None and mesh.launched_by_torchrun()
    if own:
        group = mesh.init_data_group()
    try:
        return _run(args, group)
    finally:
        if own:
            torch.distributed.destroy_process_group()


def _run(args, group) -> dict:
    from repro_torch.train import fsdp
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    device = mesh.local_device(args.device)
    host_mesh = None
    if group is not None:
        host_mesh = mesh.make_host_mesh(device_type=device.type)
        group = host_mesh.get_group("data")
    ranks = mesh.data_axis_size(group) if group is not None else 1
    rank = mesh.data_rank(group) if group is not None else 0
    state, step = build(cfg, lr=args.lr, accum_steps=args.accum_steps,
                        device=device, mesh=host_mesh)
    # params counts every expert of the config; held, what this device
    # holds (a share of them under ``MoECfg.expert_share``, a slice of
    # each under ZeRO-3)
    held = sum(p.numel() for p in tree_leaves(state["params"]))
    sizes = {"held_bytes": fsdp.held_bytes(state)}
    sizes["whole_state_bytes"] = sizes["held_bytes"] \
        if step.shardings is None else fsdp.held_bytes(fsdp.whole_template(
            state, fsdp.dims_of(step.shardings), group))
    print(f"arch={cfg.name} params={cfg.param_count() / 1e6:.1f}M "
          f"held={held / 1e6:.1f}M device={device} data_ranks={ranks} "
          f"zero3={step.shardings is not None} "
          f"held_bytes={sizes['held_bytes']} "
          f"whole_state_bytes={sizes['whole_state_bytes']}")
    data = make_pipeline(cfg, seq_len=args.seq_len,
                         global_batch=args.global_batch,
                         path=args.data_path, n_shards=ranks, shard=rank)
    ckpt_dir = _ckpt_dir(args.ckpt_dir, group, rank)
    try:
        return _loop(args, cfg, state, step, data, ckpt_dir, device, group,
                     sizes, rank)
    finally:
        if args.ckpt_dir is None and rank == 0:
            shutil.rmtree(ckpt_dir, ignore_errors=True)


def _ckpt_dir(path, group, rank) -> str:
    """The checkpoint directory: ``path``, or a temporary one; made by
    rank 0, whose choice every rank of ``group`` takes, and checked to be
    there on each."""
    if rank == 0:
        path = path or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
        os.makedirs(path, exist_ok=True)
    if group is None:
        return path
    box = [path]
    torch.distributed.broadcast_object_list(
        box, src=torch.distributed.get_global_rank(group, 0), group=group)
    if not os.path.isdir(box[0]):
        raise RuntimeError(f"rank {rank} does not see rank 0's checkpoint "
                           f"directory {box[0]!r}: give --ckpt-dir on "
                           f"storage every rank shares")
    return box[0]


def params_crc32(params) -> int:
    """A CRC32 of the bytes of every leaf of ``params``, in order."""
    crc = 0
    for leaf in tree_leaves(params):
        crc = zlib.crc32(ckpt_lib.to_numpy(leaf)[0], crc)
    return crc


def _loop(args, cfg, state, step, data, ckpt_dir, device, group, sizes,
          rank) -> dict:
    from repro_torch.train import fsdp
    sharded = {}
    if step.shardings is not None:
        sharded = fsdp.resilience(ckpt_dir, fsdp.dims_of(step.shardings),
                                  group, device=device)

    def restore_fn(template):
        if sharded:
            return sharded["restore_fn"](template)
        if group is not None:
            from repro_torch.train.distributed import restore_latest_dp
            return restore_latest_dp(ckpt_dir, template, group)
        return ckpt_lib.restore_latest(ckpt_dir, template)

    # walk-back resume: a corrupt or torn newest checkpoint degrades to the
    # newest one that restores
    state, start = restore_fn(state)
    if start:
        print(f"resuming from checkpoint step {start}")
    chaos = None
    if args.chaos_seed is not None:
        from repro_torch.train.chaos import ChaosEngine, ChaosSchedule
        hosts = [f"host{i}" for i in range(args.chaos_hosts)]
        sched = ChaosSchedule.generate(args.chaos_seed, n_steps=args.steps,
                                       hosts=hosts)
        chaos = ChaosEngine(sched, hosts=hosts, ckpt_dir=ckpt_dir,
                            writer=rank == 0)
        print(f"chaos: seed={args.chaos_seed} "
              f"events={[type(e).__name__ for e in sched.events]}")
    loop = ResilientLoop(step_fn=step, state=state, data=data,
                         ckpt_dir=ckpt_dir, ckpt_every=args.ckpt_every,
                         policy_every=5, chaos=chaos, writer=rank == 0,
                         restore_fn=restore_fn, group=group,
                         snapshot_fn=sharded.get("snapshot_fn"),
                         heartbeat=(chaos.make_heartbeat()
                                    if chaos is not None else None))
    _sync(device)
    t0 = time.perf_counter()
    final = loop.run(args.steps, start_step=start)
    _sync(device)
    seconds = time.perf_counter() - t0
    crc = params_crc32(final["params"] if not sharded else
                       sharded["snapshot_fn"](final)["params"])
    log = loop.metrics_log
    for m in log[:3] + log[-3:]:
        print(json.dumps(m))
    tokens = (args.steps - start) * args.global_batch * args.seq_len
    summary = {"arch": cfg.name, "device": str(device), "steps": args.steps,
               "data_ranks": (torch.distributed.get_world_size(group)
                              if group is not None else 1),
               "tokens_per_s": tokens / seconds,
               "first": log[0] if log else None,
               "last": log[-1] if log else None,
               "resilience": loop.resilience_summary(),
               "params_crc32": crc, "zero3": bool(sharded),
               **sizes}
    if group is not None:
        crcs = [None] * torch.distributed.get_world_size(group)
        torch.distributed.all_gather_object(crcs, crc, group=group)
        summary["ranks_agree"] = len(set(crcs)) == 1
    print(f"tokens/s={tokens / seconds:.0f}  restarts={loop.restarts}")
    print("resilience " + json.dumps(loop.resilience_summary()))
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
