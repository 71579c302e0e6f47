"""Rank bodies of the port's multi-rank CPU tests, started by
``repro_torch.launch.ranks.run_ranks`` (a ``file://`` store under the
test's ``tmp_path``, gloo, one torch thread a rank).  Each takes
``(rank, group, **args)`` and returns what the test compares in the
parent, where the JAX reference runs.  No JAX here: the ranks import the
port only."""
import os

import torch

from repro_torch.graph import GxM, resnet50
from repro_torch.launch.ranks import run_ranks
from repro_torch.optim.adamw import tree_map

# each rank's deadline: a hung collective fails its test, not the suite
RANK_TIMEOUT_S = 120.0
_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(os.path.dirname(_HERE), "src")


def spawn(body: str, world: int, tmp_path, **args) -> list:
    """Run ``body`` (a function of this module) on ``world`` CPU ranks
    over gloo, meeting through a store under ``tmp_path``; returns each
    rank's value."""
    results, _ = run_ranks(f"_dp_ranks:{body}", world,
                           workdir=os.path.join(str(tmp_path), "ranks"),
                           args=args, timeout_s=RANK_TIMEOUT_S,
                           env={"PYTHONPATH": os.pathsep.join([_SRC, _HERE])})
    return results


def _tiny():
    return GxM(resnet50(num_classes=10, stages=(1, 1, 1, 1)), device="cpu",
               num_classes=10)


def _np(tree):
    return tree_map(lambda t: t.detach().numpy().copy(), tree)


# -- optim/compress -----------------------------------------------------------

def compressed_psum_rank(rank, group, *, grads, residuals):
    """``compressed_psum`` of this rank's row of each stacked leaf, and
    ``compressed_psum_tree`` of the same tree."""
    from repro_torch.optim import compress
    leaf = {k: (compress.compressed_psum(torch.from_numpy(g[rank]), group,
                                         torch.from_numpy(residuals[k][rank])))
            for k, g in grads.items()}
    tree, res = compress.compressed_psum_tree(
        {k: torch.from_numpy(g[rank]) for k, g in grads.items()}, group,
        {k: torch.from_numpy(r[rank]) for k, r in residuals.items()})
    return {"leaf": {k: (a.numpy(), b.numpy()) for k, (a, b) in leaf.items()},
            "tree": (_np(tree), _np(res)),
            "wire_bytes": compress.last_wire_bytes}


# -- train/distributed: the CNN step ------------------------------------------

def cnn_step_rank(rank, group, *, tree, batch, lr, grad_compress="off",
                  accum_steps=(1,), steps=1, single=False):
    """The data-parallel step on this rank's half of ``batch`` from the
    reference's params ``tree``: for each of ``accum_steps``, ``steps``
    steps; with ``single`` also the single-device step on this rank's
    half.  Returns params and losses as numpy."""
    from repro_torch.convert import params_from_jax
    from repro_torch.train import distributed as D
    from repro_torch.train.step import make_cnn_train_step
    m = _tiny()
    params = params_from_jax(tree, "cpu")
    half = D.shard_cnn_batch(batch, group)
    out = {}
    for accum in accum_steps:
        state = D.init_cnn_train_state_dp(params, group,
                                          grad_compress=grad_compress)
        step = D.make_cnn_train_step_dp(m, group, lr=lr, accum_steps=accum,
                                        grad_compress=grad_compress)
        losses = []
        for _ in range(steps):
            state, metrics = step(state, half)
            losses.append(float(metrics["loss"]))
        out[accum] = {"params": _np(state["params"]), "losses": losses,
                      "residual": _np(state.get("residual", {}))}
    if single:
        p, loss = make_cnn_train_step(m, lr=lr)(params, half)
        out["single"] = {"params": _np(p), "loss": float(loss)}
    return out


def warmup_rank(rank, group, *, cache_dir, global_batch):
    """``warmup_cnn_train_dp`` with a cache file of this rank's own: rank
    0 tunes, rank 1 installs the broadcast."""
    from repro_torch.train.distributed import warmup_cnn_train_dp
    from repro_torch.tune.cache import TuneCache
    cache = TuneCache(f"{cache_dir}/rank{rank}.json")
    report, payload = warmup_cnn_train_dp(_tiny(), group,
                                          global_batch=global_batch,
                                          image_hw=(32, 32), mode="tune",
                                          backend="cpu", cache=cache)
    fresh = TuneCache(f"{cache_dir}/rank{rank}.json")
    return {"report": [dict(e, plan=None) for e in report],
            "payload": payload, "persisted": len(fresh)}


# -- train/step: the LM step --------------------------------------------------

def lm_step_rank(rank, group, *, arch, tree, opt_state, batch, lr,
                 moe_arch=None):
    """One data-parallel LM step (AdamW eps 1e-3, clip 1.0) of the
    reference's params on this rank's half of ``batch``; with
    ``moe_arch``, also the error ``make_train_step`` raises for that
    config under the group."""
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.convert import params_from_jax
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import step as step_lib
    cfg = smoke_config(get_config(arch))
    state = {"params": params_from_jax(tree, "cpu"),
             "opt": params_from_jax(opt_state, "cpu"),
             "step": torch.zeros((), dtype=torch.int32)}
    n = group.size()
    b = len(batch["labels"]) // n
    half = {k: v[rank * b:(rank + 1) * b] for k, v in batch.items()}
    step = step_lib.make_train_step(cfg, AdamW(eps=1e-3), lr=lr, clip=1.0,
                                    group=group)
    new, metrics = step(state, half)
    out = {"params": _np(new["params"]), "loss": float(metrics["loss"]),
           "grad_norm": float(metrics["grad_norm"])}
    if moe_arch is not None:
        try:
            step_lib.make_train_step(smoke_config(get_config(moe_arch)),
                                     AdamW(), group=group)
            out["moe_error"] = "no error"
        except ValueError as e:
            out["moe_error"] = str(e)
    return out


# -- resilience ---------------------------------------------------------------

def chaos_replay_rank(rank, group, *, tree, ckpt_root, steps):
    """The data-parallel int8 CNN step through ``ResilientLoop`` twice:
    uninterrupted, and under a step fault after a corrupted newest
    checkpoint.  Returns both final states and the chaos run's summary."""
    from repro_torch.convert import params_from_jax
    from repro_torch.data import SyntheticImageData
    from repro_torch.train import distributed as D
    from repro_torch.train.chaos import (ChaosEngine, ChaosSchedule,
                                         CorruptCheckpoint, StepFault)
    from repro_torch.train.fault_tolerance import ResilientLoop
    m = _tiny()
    params = params_from_jax(tree, "cpu")
    data = SyntheticImageData(hw=32, n_classes=10, global_batch=4,
                              n_shards=2, shard=rank)
    out = {}
    for name, chaos in (("clean", False), ("chaos", True)):
        ckpt_dir = f"{ckpt_root}/{name}"
        engine = ChaosEngine(
            ChaosSchedule((CorruptCheckpoint(5), StepFault(5))),
            hosts=["host0", "host1"], ckpt_dir=ckpt_dir,
            writer=rank == 0) if chaos else None
        kw = D.cnn_dp_resilience(ckpt_dir, group)
        loop = ResilientLoop(
            step_fn=D.make_cnn_train_step_dp(m, group, lr=0.05,
                                             grad_compress="int8"),
            state=D.init_cnn_train_state_dp(params, group,
                                            grad_compress="int8"),
            data=data, ckpt_dir=ckpt_dir, ckpt_every=2, policy_every=0,
            chaos=engine,
            heartbeat=engine.make_heartbeat() if engine else None, **kw)
        final = loop.run(steps)
        out[name] = {"params": _np(final["params"]),
                     "residual": _np(final["residual"]),
                     "step": int(final["step"]),
                     "summary": loop.resilience_summary(),
                     "skipped": [s for s, _ in kw["restore_fn"].skipped]}
    return out


def elastic_rank(rank, group, *, ckpt_dir, step, template):
    """``elastic_reshard_cnn`` of a checkpoint written at a wider group
    onto this group: this rank's row of the folded residual."""
    from repro_torch.train.fault_tolerance import elastic_reshard_cnn
    tmpl = tree_map(torch.as_tensor, template)
    state = elastic_reshard_cnn(ckpt_dir, step, tmpl, group)
    return {"residual": _np(state["residual"]),
            "params": _np(state["params"])}


def trainer_rank(rank, group, *, argv):
    """``launch.train.main`` on this rank, uninterrupted and with
    ``argv``'s chaos flags; returns both summaries."""
    from repro_torch.launch import train
    clean = [a for i, a in enumerate(argv) if not (
        a == "--chaos-seed" or (i and argv[i - 1] == "--chaos-seed"))]
    return {"clean": train.main(clean, group=group),
            "chaos": train.main(argv, group=group)}


def one_rank_fails_rank(rank, group, *, ckpt_dir, fail_step):
    """``ResilientLoop`` over a step with an all-reduce, in a group whose
    collectives time out after 10 s: rank 1 raises inside its step at
    ``fail_step`` while rank 0 enters the all-reduce.  Returns what each
    rank's loop raised, its restarts and the steps its step_fn began."""
    import datetime

    import torch.distributed as dist

    from repro_torch.train.fault_tolerance import ResilientLoop
    short = dist.new_group([0, 1], timeout=datetime.timedelta(seconds=10))
    began = []

    def step_fn(state, batch):
        began.append(batch)
        if rank == 1 and batch == fail_step:
            raise RuntimeError("rank 1 alone fails")
        t = torch.ones(1)
        dist.all_reduce(t, group=short)
        return state + float(t), {"loss": 0.0}

    class Data:
        def batch_at(self, step):
            return step

    loop = ResilientLoop(step_fn=step_fn, state=0.0, data=Data(),
                         ckpt_dir=ckpt_dir if rank == 0 else
                         f"{ckpt_dir}-unused", ckpt_every=1,
                         policy_every=0, writer=rank == 0, group=short)
    try:
        loop.run(fail_step + 3)
        error = None
    except Exception as e:  # noqa: BLE001
        error = repr(e)
    return {"error": error, "restarts": loop.restarts, "began": began}
