"""Start a data group of rank processes on this host and collect what each
returns: the harness of the port's multi-rank tests and of
``chip_smoke.py``'s data-parallel phase.

``run_ranks("module:function", world, workdir=...)`` starts ``world``
processes of ``python -m repro_torch.launch.ranks``; each sets its torch
threads, joins a process group through a ``file://`` store in ``workdir``
(no TCP port, so concurrent runs never clash), calls
``function(rank, group, **args)`` and saves its return value
(``torch.save``).  Every rank has one deadline, ``timeout_s``: a rank
still running then is killed with its peers and the call raises, so a hung
collective fails its caller instead of blocking it.  A rank that raises
fails the call with its error output; nothing is retried.  Two ranks may
share one card over the "gloo" backend, which reduces CUDA tensors through
host memory (NCCL refuses two ranks on one device).

  python -m repro_torch.launch.ranks --target mod:fn --rank 0 --world 2 --dir D
"""
from __future__ import annotations

import argparse
import importlib
import os
import subprocess
import sys
import time


def run_ranks(target: str, world: int, *, workdir, args: dict | None = None,
              timeout_s: float = 120.0, backend: str = "gloo",
              threads: int = 1, env: dict | None = None,
              echo: bool = False) -> tuple[list, list[str]]:
    """Run ``target`` ("module:function") on ``world`` ranks; returns
    (each rank's return value, each rank's standard output).  ``env`` adds
    to the children's environment; ``echo`` prints each rank's output as
    it ends."""
    import torch
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    if os.path.exists(store):
        os.unlink(store)
    torch.save(args or {}, os.path.join(workdir, "args.pt"))
    child_env = dict(os.environ, **(env or {}))
    procs = []
    for rank in range(world):
        out = open(os.path.join(workdir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.ranks", "--target",
             target, "--rank", str(rank), "--world", str(world), "--dir",
             str(workdir), "--backend", backend, "--threads", str(threads)],
            stdout=out, stderr=subprocess.STDOUT, env=child_env), out))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        for rank, (p, _) in enumerate(procs):
            try:
                rc = p.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                failed = f"rank {rank} still running after {timeout_s} s"
                break
            if rc != 0:
                failed = f"rank {rank} exited with {rc}"
                break
    finally:
        for p, out in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
    logs = []
    for rank in range(world):
        with open(os.path.join(workdir, f"rank{rank}.log")) as f:
            logs.append(f.read())
        if echo:
            print(logs[-1], end="", flush=True)
    if failed is not None:
        raise RuntimeError(f"run_ranks({target!r}, {world}): {failed}\n"
                           + "\n".join(f"--- rank {r} ---\n{log[-3000:]}"
                                       for r, log in enumerate(logs)))
    return [torch.load(os.path.join(workdir, f"result{r}.pt"),
                       weights_only=False) for r in range(world)], logs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--target", required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--dir", required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--threads", type=int, default=1)
    a = ap.parse_args(argv)
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_data_group
    torch.set_num_threads(a.threads)
    mod, fn = a.target.split(":")
    target = getattr(importlib.import_module(mod), fn)
    args = torch.load(os.path.join(a.dir, "args.pt"), weights_only=False)
    store = os.path.join(a.dir, "store")
    group = init_data_group(backend=a.backend, init_method=f"file://{store}",
                            rank=a.rank, world_size=a.world)
    try:
        result = target(a.rank, group, **args)
    finally:
        dist.destroy_process_group()
    torch.save(result, os.path.join(a.dir, f"result{a.rank}.pt"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
