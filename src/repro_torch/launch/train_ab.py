"""Two checkouts' LM training step in turns, each in a process of its own:
``chip_smoke.py``'s phase 29 step (``qwen2-1.5b``, bf16, uncut, AdamW f32
state, 8 x 512 ``SyntheticLMData`` tokens, seed 0) on the card.

  python3 src/repro_torch/launch/train_ab.py OLD_CHECKOUT NEW_CHECKOUT --rounds 2

Round r runs the checkouts in the order given when r is even and reversed
when it is odd (old, new, new, old, ...), so a drift of the host or the
card over the call falls on both.  Each run builds that checkout's kernels
(``_build.build_all``, cached in its own ``build/``), takes one untimed
step and then ``--steps`` timed ones on one batch, and reports:

* ``p50_ms``: the step's median wall ms, the host waiting for the device
  after each step;
* ``host_ms``: the median ms until ``step`` returns, before that wait (the
  host's share of a step, where the device keeps up);
* ``device_ms``, ``busy_share`` and ``k7_bwd_ms``: one step under
  ``torch.profiler`` by that checkout's ``chip_smoke.trace_device`` (the
  device time of every kernel, the union of kernel intervals over the span
  from the first to the last, and the kernels named
  ``flash_attention_bwd_*``);
* ``k7_host_ms``: the median host ms a timed step spends inside K7's
  wrappers, ``attention._launch_forward`` (56 calls a step under remat)
  and ``attention.flash_attention_bwd`` (28), each wrapped in a
  ``time.perf_counter`` pair: the host work a checkout's K7 adds to a
  step, apart from the rest of the host's time, which varies between
  processes by more than that work.

Then it prints, per checkout, the medians over its rounds, and as its last
line one JSON object with every run.  The checkouts need a ``chip_smoke.py``
with ``header``, ``trace_device`` and ``device_ms_of``,
``repro_torch.launch.train.build`` and ``attention._launch_forward`` and
``flash_attention_bwd``; the card, ``nvcc`` and one free card's memory for
one run at a time.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys

# One run, in the checkout given as argv[1]: prints "TRAIN_AB <json>".
_RUN = r"""
import json, os, sys, tempfile, time
root = sys.argv[1]
sys.path.insert(0, root)
import chip_smoke as cs
sys.path.insert(0, cs.SRC)
import numpy as np
import torch
cold = tempfile.TemporaryDirectory()
os.environ["REPRO_TUNE_CACHE"] = os.path.join(cold.name, "cold.json")
card, device = cs.header()
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLMData
from repro_torch.kernels import attention as k7
from repro_torch.launch.train import build

spent = [0.0]
def timed(fn):
    def inner(*a, **kw):
        t = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t
    return inner
k7._launch_forward = timed(k7._launch_forward)
k7.flash_attention_bwd = timed(k7.flash_attention_bwd)
cfg = get_config("qwen2-1.5b")
b, l = 8, 512
state, step = build(cfg, lr=3e-4, seed=0, device=device)
batch = SyntheticLMData(cfg.vocab, l, b, seed=0).batch_at(0)
state, _ = step(state, batch)
torch.cuda.synchronize()
walls, hosts, losses, k7_host = [], [], [], []
for _ in range(int(sys.argv[2])):
    torch.cuda.synchronize()
    spent[0] = 0.0
    t0 = time.perf_counter()
    state, metrics = step(state, batch)
    hosts.append((time.perf_counter() - t0) * 1e3)
    k7_host.append(spent[0] * 1e3)
    losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    walls.append((time.perf_counter() - t0) * 1e3)
trace = cs.trace_device(lambda i: step(state, batch), 1, {})
print("TRAIN_AB " + json.dumps(dict(
    root=root, card=card, p50_ms=float(np.median(walls)), walls_ms=walls,
    host_ms=float(np.median(hosts)), losses=losses,
    device_ms=trace["device_ms"], busy_share=trace["busy_share"],
    k7_bwd_ms=cs.device_ms_of(trace, "flash_attention_bwd_"),
    k7_host_ms=float(np.median(k7_host)))), flush=True)
"""

KEYS = ("p50_ms", "host_ms", "device_ms", "busy_share", "k7_bwd_ms",
        "k7_host_ms")


def run_one(root: str, steps: int, timeout: float) -> dict:
    """One run in ``root``'s own process; its record, or SystemExit with
    the run's output tail when it fails."""
    done = subprocess.run([sys.executable, "-c", _RUN, root, str(steps)],
                          cwd=root, capture_output=True, text=True,
                          timeout=timeout)
    lines = [x for x in done.stdout.splitlines()
             if x.startswith("TRAIN_AB ")]
    if done.returncode != 0 or not lines:
        sys.stderr.write(done.stdout[-4000:] + done.stderr[-4000:])
        raise SystemExit(f"train_ab: the run in {root} failed "
                         f"(exit {done.returncode})")
    return json.loads(lines[-1].removeprefix("TRAIN_AB "))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("checkouts", nargs="+",
                    help="checkout roots, each with chip_smoke.py and src/")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--steps", type=int, default=5,
                    help="timed steps a run, after one untimed")
    ap.add_argument("--timeout", type=float, default=600.0,
                    help="seconds a run may take")
    args = ap.parse_args(argv)
    roots = [os.path.abspath(r) for r in args.checkouts]
    runs = []
    for r in range(args.rounds):
        for root in (roots if r % 2 == 0 else roots[::-1]):
            rec = run_one(root, args.steps, args.timeout)
            rec["round"] = r
            runs.append(rec)
            print(f"round {r} {root}: " + ", ".join(
                f"{key} {rec[key]}" for key in KEYS) + f"; card "
                f"{rec['card']}; losses {rec['losses']}", flush=True)
    medians = {root: {key: statistics.median(
        x[key] for x in runs if x["root"] == root) for key in KEYS}
        for root in roots}
    for root, med in medians.items():
        print(f"median over {args.rounds} rounds, {root}: " + ", ".join(
            f"{key} {val}" for key, val in med.items()))
    out = dict(rounds=args.rounds, steps=args.steps, runs=runs,
               medians=medians)
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
