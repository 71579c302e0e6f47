"""Continuous-batching CNN image-recognition server over the port's GxM —
the counterpart of ``repro/launch/serve_cnn.py`` on one GPU.

  PYTHONPATH=src python -m repro_torch.launch.serve_cnn              # full ResNet-50, cuda
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --smoke --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --arch inception
  REPRO_QUANTIZE=int8 PYTHONPATH=src python -m repro_torch.launch.serve_cnn
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --autotune off
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --fleet 4 --fleet-chaos-seed 3
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --smoke --fleet 2 --device cpu

``--autotune`` is warmup's plan-cache mode, as in the reference's CLI:
"tune" (default) tunes the kernel plan of every conv signature x bucket
into the cache (``REPRO_TUNE_CACHE``) before the window, "cache" only
reads it, "off" skips it; the requests then run under the engine's
"cache" scope, the tuned plans or the kernels' defaults on a miss.

``REPRO_QUANTIZE=int8`` serves the §II-K int8 path, as the reference's CLI
does: warmup calibrates the activation scales first, and every lane-aligned
conv runs K3.  ``REPRO_CONV_TILING=whole`` serves through the whole-plane
kernels (K10a, or K10c for int8) in place of K1 and K3.

Requests (single images) land in a queue; the scheduler drains it in
batches, each padded up to the minimal bucket of a fixed ladder
(``graph/serving.py``).  Startup warmup tunes the plans, then runs one
forward per bucket, so the kernels are built before the first request; an
untimed pass of bursts then
serves every bucket once more before the measured window opens.  The
weights are random, drawn from seed 0, and the request images are made
before the window opens, so the load generator costs the window nothing.

``--fleet N`` runs the resilient multi-replica mode instead, as the
reference's CLI does: N replicas sharing the warmed engine pair (f32
through K1, and an int8 twin through K3, calibrated at its warmup) behind
``serve.FleetRouter`` (deadlines of ``--deadline`` simulated seconds,
hedging, health eviction + respawn, load shed, degrade-to-int8), replaying
``--requests`` (24 by default in this mode) seeded Poisson arrivals at 1.5
a simulated second against the seeded replica-fault schedule of
``--fleet-chaos-seed`` or ``REPRO_SERVE_CHAOS=<seed>``.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import time

import numpy as np
import torch

from repro_torch.graph import GxM, inception_v3, resnet50
from repro_torch.graph.serving import CnnInferenceEngine, pick_bucket
from repro_torch.kernels import conv2d_direct as k1
from repro_torch.kernels import conv2d_q8 as k3


class ImageServer:
    """Continuous-batching scheduler over a ``CnnInferenceEngine``.

    ``submit`` enqueues one image and returns a request id; ``step`` serves
    one padded bucket off the queue head; ``run`` drains the queue.  Results
    map request id -> (top-1 class, top-1 logit).  ``stats`` measures the
    window from the first submit to the last result by ``clock``.
    """

    def __init__(self, engine: CnnInferenceEngine, *, clock=None):
        self.engine = engine
        self.clock = clock if clock is not None else time.perf_counter
        self.queue: collections.deque = collections.deque()
        self.results: dict[int, tuple[int, float]] = {}
        self._next_rid = 0
        self._counters = {"batches": 0, "images": 0, "padded_lanes": 0,
                          "by_bucket": collections.Counter()}
        self.latencies_s: list[float] = []
        self._first_submit = self._last_done = None

    def submit(self, image) -> int:
        rid = self._next_rid
        self._next_rid += 1
        now = self.clock()
        if self._first_submit is None:
            self._first_submit = now
        self.queue.append((rid, image, now))
        return rid

    def step(self) -> int:
        """Serve up to one largest-bucket batch from the queue head; returns
        the number of requests served (0 when the queue is empty)."""
        if not self.queue:
            return 0
        take = min(len(self.queue), max(self.engine.buckets))
        reqs = [self.queue.popleft() for _ in range(take)]
        images = np.stack([img for _, img, _ in reqs])
        bucket = pick_bucket(take, self.engine.buckets)
        st = self._counters
        # .cpu() waits for the device: the latency covers the whole forward
        logits = self.engine.infer(images).cpu().numpy()
        t1 = self._last_done = self.clock()
        for (rid, _, t_enq), row in zip(reqs, logits):
            top1 = int(np.argmax(row))
            self.results[rid] = (top1, float(row[top1]))
            self.latencies_s.append(t1 - t_enq)
        st["batches"] += 1
        st["images"] += take
        st["padded_lanes"] += bucket - take
        st["by_bucket"][bucket] += 1
        return take

    def run(self) -> dict[int, tuple[int, float]]:
        while self.queue:
            self.step()
        return dict(self.results)

    def stats(self) -> dict:
        """Counter snapshot, the enqueue->complete latency summary (queue
        wait included: what a client experiences), and images/s over the
        window's wall time, first submit to last result."""
        st = dict(self._counters)
        st["by_bucket"] = dict(st["by_bucket"])
        st["wall_s"] = (self._last_done - self._first_submit
                        if self._last_done is not None else 0.0)
        st["images_per_s"] = (st["images"] / st["wall_s"] if st["wall_s"]
                              else 0.0)
        lat = np.sort(np.asarray(self.latencies_s, dtype=np.float64))
        st["latency"] = {
            "count": int(lat.size),
            "p50_ms": float(np.percentile(lat, 50)) * 1e3 if lat.size else 0.0,
            "p99_ms": float(np.percentile(lat, 99)) * 1e3 if lat.size else 0.0,
            "max_ms": float(lat[-1]) * 1e3 if lat.size else 0.0,
        }
        return st


def build_model(*, smoke: bool, device=None, arch: str = "resnet50"):
    """Full ResNet-50 (1000 classes, 224x224), or with ``smoke`` the tiny one
    (one block per stage, 10 classes, 32x32); ``arch="inception"``:
    Inception-v3 (1000 classes, 299x299, its native size), or with
    ``smoke`` 10 classes at 48x48.  Returns (GxM, image size)."""
    classes = 10 if smoke else 1000
    if arch == "resnet50":
        net = resnet50(classes, stages=(1, 1, 1, 1)) if smoke \
            else resnet50(classes)
        image = 32 if smoke else 224
    elif arch == "inception":
        net, image = inception_v3(classes), 48 if smoke else 299
    else:
        raise ValueError(f"unknown arch {arch!r}; valid: resnet50, "
                         f"inception")
    return GxM(net, device=device, num_classes=classes), image


def make_images(n: int, image: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` random (image, image, 3) f32 request images, made up front."""
    return rng.standard_normal((n, image, image, 3), dtype=np.float32)


def serve_bursts(server: ImageServer, images: np.ndarray, *,
                 rng: np.random.Generator) -> dict:
    """Submit ``images`` in bursts, stepping once per burst, then drain the
    queue.  The first bursts are one of each bucket size, so every bucket is
    served; the rest draw their size uniformly up to the largest bucket, so
    partial buckets (and pad-to-bucket) happen.  Returns the results."""
    buckets = sorted(server.engine.buckets)
    sizes = iter(buckets)
    i = 0
    while i < len(images):
        size = next(sizes, None) or int(rng.integers(1, buckets[-1] + 1))
        for img in images[i:i + size]:
            server.submit(img)
        i += size
        server.step()
    return server.run()


def serve_window(engine: CnnInferenceEngine, *, requests: int, seed: int = 0,
                 warm_requests: int = 64) -> tuple[ImageServer, dict]:
    """The measured serving window: ``warm_requests`` in bursts through a
    throwaway server (untimed), then ``requests`` through a fresh one.  All
    images are made before either starts, and the launch counts of K1 and
    K3, and of their whole-plane forms K10a and K10c (with K1's, K10a's
    and K10c's mma-route counts and K3's ring-route count), are set to 0
    as the window opens.  Returns (server, results)."""
    rng = np.random.default_rng(seed)
    image = engine.image_hw[0]
    warm = make_images(warm_requests, image, rng)
    window = make_images(requests, image, rng)
    serve_bursts(ImageServer(engine), warm, rng=rng)
    k1.launches = k3.launches = k1.launches_mma = k3.launches_ring = 0
    k1.launches_whole = k3.launches_whole = k1.launches_whole_mma = 0
    k3.launches_whole_mma = 0
    server = ImageServer(engine)
    return server, serve_bursts(server, window, rng=rng)


def run_fleet(args, engine, q8_engine, image: int) -> dict:
    """The resilient multi-replica mode: ``args.fleet`` replicas sharing the
    warmed engine pair behind ``serve.FleetRouter``, replaying seeded
    Poisson arrivals against the ``REPRO_SERVE_CHAOS``-seeded fault
    schedule (the reference's ``run_fleet``).  Prints and returns the
    summary: the router's report without its events, and the K1 and K3
    launches of the run with K1's on the mma route and K3's on the ring."""
    from repro_torch.serve import (FleetRouter, Replica, ServeChaosEngine,
                                   ServeChaosSchedule, poisson_arrivals)
    names = [f"r{i}" for i in range(args.fleet)]
    make_replica = lambda name: Replica(  # noqa: E731
        name, infer_fn=engine.infer,
        q8_infer_fn=q8_engine.infer if q8_engine is not None else None)
    arrivals = poisson_arrivals(0, n=args.requests, rate_per_s=1.5)
    horizon = max(t for t, _ in arrivals)
    chaos = None
    if args.fleet_chaos_seed is not None:
        schedule = ServeChaosSchedule.generate(
            args.fleet_chaos_seed, horizon_s=horizon, replicas=names)
        chaos = ServeChaosEngine(schedule)
        print(f"chaos: seed {args.fleet_chaos_seed}, "
              f"{len(schedule.events)} events over {horizon:.0f}s")
    rng = np.random.default_rng(0)
    image_fn = lambda _i: rng.standard_normal(  # noqa: E731
        (image, image, 3)).astype(np.float32)
    router = FleetRouter([make_replica(n) for n in names], chaos=chaos,
                         deadline_s=args.deadline,
                         replica_factory=make_replica,
                         burst_image_fn=image_fn)
    requests = [(t, image_fn(0)) for t, _ in arrivals]
    k1.launches = k3.launches = k1.launches_mma = k3.launches_ring = 0
    report = router.run(requests)
    report.pop("events")
    summary = {"arch": args.arch, "device": str(engine.device),
               "fleet": args.fleet, "chaos_seed": args.fleet_chaos_seed,
               **report, "conv2d_direct_launches": k1.launches,
               "conv2d_direct_mma_launches": k1.launches_mma,
               "conv2d_q8_launches": k3.launches,
               "conv2d_q8_ring_launches": k3.launches_ring}
    print(json.dumps(summary))
    if not all(r.result is not None for r in router.requests.values()
               if r.status == "done"):
        raise RuntimeError("a done request has no result")
    if report["slo_handled_rate"] != 1.0:
        raise RuntimeError("an admitted request busted its deadline without "
                           "degrading")
    return summary


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=("resnet50", "inception"),
                    default="resnet50")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny topology (ResNet-50: one block per stage, "
                         "32x32; Inception-v3: 48x48), 10 classes")
    ap.add_argument("--autotune", choices=("off", "cache", "tune"),
                    default="tune", help="warmup's plan-cache mode")
    ap.add_argument("--requests", type=int, default=None,
                    help="requests to serve (512; 24 with --fleet)")
    ap.add_argument("--max-batch", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; raises without a GPU)")
    ap.add_argument("--fleet", type=int, default=0,
                    help="serve from N replicas behind the resilient "
                         "FleetRouter (0: single-engine batching)")
    ap.add_argument("--fleet-chaos-seed", type=int,
                    default=(int(os.environ["REPRO_SERVE_CHAOS"])
                             if os.environ.get("REPRO_SERVE_CHAOS")
                             else None),
                    help="inject a seeded replica-fault schedule "
                         "(serve/chaos.py) into --fleet mode; also "
                         "settable via REPRO_SERVE_CHAOS=<seed>")
    ap.add_argument("--deadline", type=float, default=6.0,
                    help="--fleet per-request deadline (simulated seconds)")
    args = ap.parse_args(argv)
    if args.requests is None:
        args.requests = 24 if args.fleet else 512

    m, image = build_model(smoke=args.smoke, device=args.device,
                           arch=args.arch)
    params = m.init(torch.Generator().manual_seed(0))
    engine = CnnInferenceEngine(m, params, image_hw=(image, image),
                                max_batch=args.max_batch)
    t0 = time.perf_counter()
    report = engine.warmup(autotune=args.autotune)
    warm_s = time.perf_counter() - t0
    print(f"warmup: {report['conv_signatures']} conv signatures "
          f"({report['kernel_path_signatures']} on the kernel path), "
          f"{report['tune_entries']} plan-cache entries "
          f"({args.autotune}), buckets {report['buckets']}, "
          f"{'int8' if report['quantized'] else 'f32'}, in {warm_s:.1f}s")

    if args.fleet:
        if engine.quantized:
            raise ValueError("--fleet serves an f32 engine with an int8 "
                             "twin: unset REPRO_QUANTIZE")
        mq, _ = build_model(smoke=args.smoke, device=args.device,
                            arch=args.arch)
        # quantized=True re-marks mq's ETG: the int8 degrade twin, on the
        # same f32 params, calibrated by its warmup
        q8_engine = CnnInferenceEngine(mq, params, image_hw=(image, image),
                                       max_batch=args.max_batch,
                                       quantized=True)
        q8_engine.warmup(autotune="off")
        return run_fleet(args, engine, q8_engine, image)

    server, results = serve_window(engine, requests=args.requests)
    st = server.stats()
    summary = {
        "device": str(m.device), "arch": args.arch, "image": image,
        "autotune": args.autotune, "tune_entries": report["tune_entries"],
        "quantized": engine.quantized,
        "requests": len(results), "batches": st["batches"],
        "pad_fraction": st["padded_lanes"]
        / max(st["images"] + st["padded_lanes"], 1),
        "by_bucket": st["by_bucket"],
        "latency_p50_ms": st["latency"]["p50_ms"],
        "latency_p99_ms": st["latency"]["p99_ms"],
        "wall_s": st["wall_s"],
        "images_per_s": st["images_per_s"],
        "conv_tiling": report["conv_tiling"],
        "conv2d_direct_launches": k1.launches,
        "conv2d_direct_mma_launches": k1.launches_mma,
        "conv2d_q8_launches": k3.launches,
        "conv2d_q8_ring_launches": k3.launches_ring,
        "conv2d_direct_whole_launches": k1.launches_whole,
        "conv2d_direct_whole_mma_launches": k1.launches_whole_mma,
        "conv2d_q8_whole_launches": k3.launches_whole,
    }
    print(json.dumps(summary))
    if len(results) != args.requests:
        raise RuntimeError(f"served {len(results)} of {args.requests}")
    return summary


if __name__ == "__main__":
    main()
