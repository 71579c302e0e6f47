"""Default against tuned kernel plans, in turns: a training step, or with
``--serve`` the f32 and int8 serving windows.

  PYTHONPATH=src python -m repro_torch.launch.plan_ab                 # cuda
  PYTHONPATH=src python -m repro_torch.launch.plan_ab --serve
  PYTHONPATH=src python -m repro_torch.launch.plan_ab --smoke --device cpu

Tunes every plan one ResNet-50 SGD step launches (``warmup_cnn_train``:
kinds "fwd", "bwd", "wu") into a cache in a temporary directory, writes a
second cache whose every entry holds the kernel's default plan, and then
runs the step in turns, reversing the order every round: with
``autotune="off"``, under "cache" on the tuned entries, and under "cache"
on the default entries (the consult's own cost, plans unchanged).  It
prints, per mode, the step's median and quartile wall ms, the rounds the
tuned step won against "off", the host microseconds of one
``tune.resolve_plan`` under "off" and "cache", and on the card the device
ms a step by ``torch.profiler``; then one JSON line with all of it.  The
weights are random from seed 0.  On the CPU the kernels' plain versions
run, which take no plan: the timings then say nothing of the card.

``--serve`` builds ResNet-50's f32 and int8 engines (max_batch 16) twice
over one params tree: one warmed with ``autotune="tune"`` into a cache in a
temporary directory and serving under "cache", one serving with
``autotune="off"``; it serves ``launch.serve_cnn.serve_window`` (64
untimed, then ``--requests``) with each in turns, reversing the order every
round, and prints each mode's images/s and p50 per round, their medians
and the rounds the tuned engine won.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import re
import tempfile
import time

import numpy as np
import torch

from repro_torch import backend as be
from repro_torch import tune
from repro_torch.launch.train_cnn import build_trainer
from repro_torch.train.step import make_cnn_train_step, warmup_cnn_train
from repro_torch.tune import space

MODES = ("off", "cache_tuned", "cache_default")


@contextlib.contextmanager
def _cache_file(path: str):
    prev = os.environ.get("REPRO_TUNE_CACHE")
    os.environ["REPRO_TUNE_CACHE"] = path
    try:
        yield
    finally:
        if prev is None:
            del os.environ["REPRO_TUNE_CACHE"]
        else:
            os.environ["REPRO_TUNE_CACHE"] = prev


def default_entries(tuned: str, out: str) -> int:
    """Copy the cache file ``tuned`` to ``out`` with every plan entry's
    plan replaced by the kernel's default plan for its key.  Returns the
    entries rewritten."""
    with open(tuned, encoding="utf-8") as f:
        blob = json.load(f)
    for key, entry in blob["entries"].items():
        kind = key.split("|")[1]
        if kind not in space.PLAN_KINDS:
            continue
        n, h, w, c, k, r, s, stride, padding = map(int, re.search(
            r"\|n(\d+)h(\d+)w(\d+)c(\d+)k(\d+)r(\d+)s(\d+)"
            r"\|st(\d+)pd(\d+)\|", key).groups())
        entry["blocking"] = dataclasses.asdict(space.default_plan(
            kind, n=n, h=h, w=w, c=c, k=k, r=r, s=s, stride=stride,
            padding=padding))
    with open(out, "w", encoding="utf-8") as f:
        json.dump(blob, f)
    return len(blob["entries"])


def resolve_us(mode: str, calls: int = 10000) -> float:
    """Host microseconds of one memoised ``tune.resolve_plan``."""
    shape = dict(n=16, h=14, w=14, c=256, k=256, r=3, s=3, stride=1,
                 padding=1)
    with be.use_autotune(mode):
        tune.resolve_plan("fwd", **shape)
        t0 = time.perf_counter()
        for _ in range(calls):
            tune.resolve_plan("fwd", **shape)
        return (time.perf_counter() - t0) / calls * 1e6


def serve_ab(device, *, smoke: bool, rounds: int, requests: int) -> dict:
    """The f32 and int8 serving windows with default and tuned plans, in
    turns (see the module docstring)."""
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.launch.serve_cnn import build_model, serve_window
    out = {}
    with tempfile.TemporaryDirectory() as tmp, \
            _cache_file(os.path.join(tmp, "tuned.json")):
        params = None
        for quantized in (False, True):
            name = "int8" if quantized else "f32"
            engines = {}
            for mode in ("off", "cache"):
                gxm, image = build_model(smoke=smoke, device=device)
                params = params or gxm.init(torch.Generator().manual_seed(0))
                engines[mode] = CnnInferenceEngine(
                    gxm, params, image_hw=(image, image), max_batch=16,
                    quantized=quantized, autotune=mode)
                engines[mode].warmup(autotune="tune" if mode == "cache"
                                     else "off")
            runs = {mode: [] for mode in engines}
            for i in range(rounds):
                for mode in (("off", "cache") if i % 2 == 0
                             else ("cache", "off")):
                    st = serve_window(engines[mode], requests=requests,
                                      seed=i)[0].stats()
                    runs[mode].append((st["images_per_s"],
                                       st["latency"]["p50_ms"]))
            res = {mode: dict(images_per_s=[r[0] for r in v],
                              p50_ms=[r[1] for r in v],
                              median_images_per_s=float(np.median(
                                  [r[0] for r in v])))
                   for mode, v in runs.items()}
            res["tuned_wins_of_rounds"] = sum(
                c[0] > o[0] for c, o in zip(runs["cache"], runs["off"]))
            for mode in ("off", "cache"):
                print(f"{name} serving, plans {mode:5s}: images/s median "
                      f"{res[mode]['median_images_per_s']:.2f} (rounds "
                      f"{', '.join(f'{x:.1f}' for x in res[mode]['images_per_s'])})")
            print(f"{name}: tuned faster in {res['tuned_wins_of_rounds']} "
                  f"of {rounds} rounds")
            out[name] = res
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true",
                    help="one block per stage, 32x32, batch 2, 2 rounds")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--serve", action="store_true",
                    help="the serving windows in place of the step")
    ap.add_argument("--requests", type=int, default=256,
                    help="requests of a serving window (--serve)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    args = ap.parse_args(argv)
    device = be.resolve_device(args.device)
    if args.serve:
        out = {"device": str(device), "serve": serve_ab(
            device, smoke=args.smoke, rounds=2 if args.smoke
            else args.rounds, requests=8 if args.smoke else args.requests)}
        print(json.dumps(out))
        return out
    image, batch = (32, 2) if args.smoke else (224, 32)
    rounds = 2 if args.smoke else args.rounds
    out = {"device": str(device), "image": image, "batch": batch,
           "rounds": rounds}
    if device.type == "cuda":
        out["card"] = torch.cuda.get_device_name(0)
    with tempfile.TemporaryDirectory() as tmp:
        tuned, dflt = (os.path.join(tmp, f"{name}.json")
                       for name in ("tuned", "default"))
        gxm, params, step_cache, data = build_trainer(
            full=not args.smoke, num_classes=10 if args.smoke else 1000,
            image=image, batch=batch, lr=0.1, device=device, seed=0,
            autotune="cache")
        with _cache_file(tuned):
            report = warmup_cnn_train(gxm, image_hw=(image, image),
                                      minibatch=batch)
        out["plans"] = len({e["key"] for e in report if e["cached"]})
        out["default_entries"] = default_entries(tuned, dflt)
        steps = {"off": (make_cnn_train_step(gxm, lr=0.1, autotune="off"),
                         tuned),
                 "cache_tuned": (step_cache, tuned),
                 "cache_default": (step_cache, dflt)}
        batches = [{key: torch.as_tensor(v, device=device)
                    for key, v in data.batch_at(i).items()}
                   for i in range(2)]

        def run(mode, b):
            step, path = steps[mode]
            with _cache_file(path):
                loss = step(params, b)[1]
                if device.type == "cuda":
                    torch.cuda.synchronize()
            return loss

        for mode in MODES:                  # warm: build, tune nothing
            for b in batches:
                run(mode, b)
        times = {mode: [] for mode in MODES}
        for i in range(rounds):
            for mode in (MODES if i % 2 == 0 else MODES[::-1]):
                t0 = time.perf_counter()
                run(mode, batches[i % 2])
                times[mode].append((time.perf_counter() - t0) * 1e3)
        for mode, v in times.items():
            q1, med, q3 = np.percentile(v, [25, 50, 75])
            out[mode] = dict(median_ms=float(med), q1_ms=float(q1),
                             q3_ms=float(q3))
            print(f"{mode:13s} step median {med:.3f} ms (quartiles "
                  f"{q1:.3f}-{q3:.3f})")
        out["tuned_wins_of_rounds"] = sum(
            a < b for a, b in zip(times["cache_tuned"], times["off"]))
        print(f"cache_tuned faster than off in "
              f"{out['tuned_wins_of_rounds']} of {rounds} rounds")
        for mode in ("off", "cache"):
            with _cache_file(tuned):
                out[f"resolve_plan_us_{mode}"] = resolve_us(mode)
            print(f"resolve_plan under {mode}: "
                  f"{out[f'resolve_plan_us_{mode}']:.3f} us a call")
        if device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            for mode in MODES:
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as prof:
                    for b in batches + batches[:1]:
                        run(mode, b)
                dev = sum(e.self_device_time_total
                          for e in prof.key_averages()
                          if e.device_type.name == "CUDA") / 3 / 1e3
                out[mode]["device_ms"] = dev
                print(f"{mode:13s} device {dev:.3f} ms a step (profiler)")
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
