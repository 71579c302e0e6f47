#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each of which fails the run (nonzero exit, no result line):

1. Header: the card's name and power limit, torch and CUDA versions, the
   TF32 flags, and the build of every CUDA kernel from ``src/repro_torch/csrc``.
2. Kernel vs plain: every distinct lane-aligned (shape, fused epilogue)
   signature of ResNet-50 at 224x224, batch 16, on random weights, BN scale,
   shift and residual: K1 against its plain PyTorch version (max |diff| /
   max |plain| <= 1e-5), with CUDA-event times of K1, the plain version and
   the library yardstick (cuDNN ``F.conv2d`` in true f32 plus the
   epilogue), and the bound (the larger of FLOPs / 67 TFLOP/s f32 and bytes
   / 3.35 TB/s).
3. Serving: full ResNet-50 (1000 classes, 224x224) with random BN running
   statistics through ``CnnInferenceEngine`` and ``ImageServer`` at
   max_batch 16: an untimed pass of 64 requests, then a window of 512
   requests in bursts that reach every bucket (1 to 16), with every image
   made before the window opens.  Images/s is over the window's wall time;
   p50/p99 are enqueue-to-result.  K1's launch count is reset just before
   the window and read just after: it must be 52 per forward.  Then the
   time of one batch-16 step by host clock: the copy to the card, the
   forward, and K1's share.
4. Slice parity: a batch of 2 images on the card against the port's CPU
   forward (the plain versions): max |diff| <= 1e-4 * max |logit| and the
   same top-1 on every image.
5. The kernels line, then the device line last.

It imports nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")
SEED = 0
BATCH = 16
IMAGE = 224
REQUESTS = 512
F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
KERNEL_REL_TOL = 1e-5
LOGIT_REL_TOL = 1e-4


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` launches, warm, by CUDA
    events around the whole run."""
    import torch
    fn()
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def header():
    import torch
    from repro_torch.backend import resolve_device
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    check(bool(smi), "nvidia-smi printed no card")
    print("card (nvidia-smi name, power.limit):")
    print(smi[0])
    device = resolve_device(None)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} device(s)")
    print(f"tf32: cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32="
          f"{torch.backends.cuda.matmul.allow_tf32}")
    check(not torch.backends.cudnn.allow_tf32
          and not torch.backends.cuda.matmul.allow_tf32, "TF32 still on")
    print(f"kernel build: conv2d_direct {_build.build('conv2d_direct'):.1f}s")
    for line in _build.build_log("conv2d_direct").splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    return smi[0], device


def kernel_signatures(device):
    """Phase 2.  Returns per-signature records, each with ``count``: how
    many conv tasks of one ResNet-50 forward share it."""
    import torch
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph import build_etg, resnet50
    from repro_torch.graph.serving import conv_shapes
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import ref

    etg = build_etg(resnet50())
    by_name = {t.name: t for t in etg.tasks}
    sigs: dict[tuple, int] = {}
    for sh in conv_shapes(etg, (IMAGE, IMAGE)):
        if not lane_ok(sh["c"], sh["k"]):
            continue
        fused = tuple(kind for kind, _ in by_name[sh["name"]].fused)
        key = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"], fused)
        sigs[key] = sigs.get(key, 0) + 1

    gen = torch.Generator(device=device).manual_seed(SEED)
    rows = []
    print(f"\nK1 vs plain, ResNet-50 {IMAGE}x{IMAGE} batch {BATCH} "
          f"({len(sigs)} signatures, {sum(sigs.values())} convs):")
    print("  h  w    c    k r st fused         count  max_rel    max_abs"
          "        ms  plain_ms  library_ms  bound_ms bound_by")
    for (h, w, c, k, r, s, st, pad, fused), count in sigs.items():
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1

        def randn(*shape, std=1.0):
            return torch.randn(shape, generator=gen, device=device) * std

        args = dict(
            x=randn(BATCH, h, w, c),
            w=randn(r, s, c, k, std=math.sqrt(2.0 / (r * s * c))),
            stride=st, padding=pad,
            scale=torch.rand(k, generator=gen, device=device) + 0.5,
            shift=randn(k, std=0.1),
            residual=randn(BATCH, p, q, k) if "add" in fused else None,
            relu="relu" in fused)
        out = k1.conv2d_direct(**args)
        plain = k1.conv2d_direct_plain(**args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K1 non-finite at {h, c, k}")
        max_abs = float((out - plain).abs().max())
        max_rel = max_abs / float(plain.abs().max())
        ms = cuda_ms(lambda: k1.conv2d_direct(**args), 50)
        plain_ms = cuda_ms(lambda: k1.conv2d_direct_plain(**args), 10)
        library_ms = cuda_ms(lambda: ref.conv2d_fused(**args), 50)
        flops = 2.0 * BATCH * p * q * k * c * r * s
        nbytes = 4.0 * (BATCH * h * w * c + r * s * c * k + BATCH * p * q * k
                        + 2 * k
                        + (BATCH * p * q * k if "add" in fused else 0))
        t_ops = flops / F32_PEAK_FLOPS * 1e3
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        rec = dict(h=h, w=w, c=c, k=k, r=r, stride=st, fused=list(fused),
                   count=count, max_rel_err=max_rel, max_abs_err=max_abs,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=max(t_ops, t_bytes),
                   bound_by="operations" if t_ops >= t_bytes else "bytes",
                   flops=flops)
        rows.append(rec)
        print(f"{h:3d}{w:3d}{c:5d}{k:5d}{r:2d}{st:3d} "
              f"{'+'.join(fused):14s}{count:5d}  {max_rel:.2e}  "
              f"{max_abs:.2e} {ms:9.4f} {plain_ms:9.4f} {library_ms:11.4f} "
              f"{rec['bound_ms']:9.4f} {rec['bound_by']}")
        check(max_rel <= KERNEL_REL_TOL,
              f"K1 disagrees with its plain version at {(h, c, k, r, st)}: "
              f"max_rel {max_rel:.3e} > {KERNEL_REL_TOL}")
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def random_bn_stats(params, gen):
    """Random BN running statistics and affine leaves, so the folded
    epilogue is not the identity."""
    import torch
    for p in params.values():
        if "var" not in p:
            continue
        k = p["var"].shape[0]
        dev = p["var"].device
        p["mean"] = (torch.randn(k, generator=gen) * 0.1).to(dev)
        p["var"] = (torch.rand(k, generator=gen) + 0.5).to(dev)
        p["scale"] = (torch.rand(k, generator=gen) + 0.5).to(dev)
        p["shift"] = (torch.randn(k, generator=gen) * 0.1).to(dev)


def serving(device):
    """Phase 3: the main path.  Returns (engine, K1 launches in it)."""
    import torch
    from repro_torch.core.conv import lane_ok
    from repro_torch.graph.serving import CnnInferenceEngine
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.launch.serve_cnn import build_model, serve_window

    gxm, image = build_model(smoke=False, device=device)
    check(image == IMAGE and gxm.num_classes == 1000,
          f"ResNet-50 image {image}, {gxm.num_classes} classes")
    gen = torch.Generator().manual_seed(SEED)
    params = gxm.init(gen)
    random_bn_stats(params, gen)
    engine = CnnInferenceEngine(gxm, params, image_hw=(image, image),
                                max_batch=BATCH)
    t0 = time.perf_counter()
    report = engine.warmup()
    print(f"\nserving: warmup of buckets {report['buckets']} in "
          f"{time.perf_counter() - t0:.2f}s "
          f"({report['kernel_path_signatures']} of "
          f"{report['conv_signatures']} conv signatures on K1)")

    # serve_window sets the K1 count to 0 just before the measured window
    server, results = serve_window(engine, requests=REQUESTS, seed=SEED)
    launches = k1.launches
    st = server.stats()
    check(len(results) == REQUESTS, f"served {len(results)} of {REQUESTS}")
    check(all(0 <= c < 1000 and math.isfinite(v)
              for c, v in results.values()), "non-finite or bad top-1")
    convs = sum(1 for t in gxm.etg.tasks if t.op == "conv")
    per_fwd = sum(1 for t in gxm.etg.tasks if t.op == "conv"
                  and lane_ok(t.attrs["c"], t.attrs["k"]))
    print(f"  {REQUESTS} requests in {st['batches']} batches "
          f"{st['by_bucket']}, {st['padded_lanes']} padded lanes")
    print(f"  images/s {st['images_per_s']:.2f} over {st['wall_s']:.3f} s "
          f"wall  p50 {st['latency']['p50_ms']:.3f} ms  "
          f"p99 {st['latency']['p99_ms']:.3f} ms  (queue wait included)")
    check(set(st["by_bucket"]) == set(engine.buckets),
          f"buckets served {sorted(st['by_bucket'])}, not {engine.buckets}")
    print(f"  K1 launches {launches} = {per_fwd} of {convs} convs x "
          f"{st['batches']} forwards")
    check(per_fwd == 52, f"{per_fwd} lane-aligned convs per forward, not 52")
    check(launches == per_fwd * st["batches"],
          f"K1 launched {launches} times, expected {per_fwd * st['batches']}")
    return engine, launches


def breakdown(engine, k1_ms: float) -> None:
    """Where a batch-16 request step spends its time, by host clock around
    work that ends in a synchronise (median of 5, after the main path):
    the host-to-device copy of the images, the forward of a batch already
    on the card, and K1's device time per forward from phase 2."""
    import numpy as np
    import torch

    def wall_ms(fn):
        times = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    host = np.random.default_rng(SEED + 2).standard_normal(
        (BATCH, IMAGE, IMAGE, 3), dtype=np.float32)
    on_card = torch.as_tensor(host, device=engine.device)
    step = wall_ms(lambda: engine.infer(host))
    h2d = wall_ms(lambda: torch.as_tensor(host, device=engine.device))
    fwd = wall_ms(lambda: engine.gxm.infer(engine.params, on_card))
    print(f"  batch {BATCH} step {step:.3f} ms: H2D {h2d:.3f} ms, forward "
          f"{fwd:.3f} ms (wall), K1 device time {k1_ms:.3f} ms "
          f"({100 * k1_ms / step:.1f}% of the step)")


def parity(engine):
    """Phase 4: the card's logits against the port's CPU forward."""
    import numpy as np
    import torch
    from repro_torch.graph import GxM, resnet50

    images = np.random.default_rng(SEED + 1).standard_normal(
        (2, IMAGE, IMAGE, 3), dtype=np.float32)
    on_card = engine.infer(images).cpu()
    cpu_params = {name: {leaf: v.cpu() for leaf, v in p.items()}
                  for name, p in engine.params.items()}
    t0 = time.perf_counter()
    on_cpu = GxM(resnet50(), device="cpu").infer(cpu_params,
                                                 torch.from_numpy(images))
    cpu_s = time.perf_counter() - t0
    check(on_card.shape == (2, 1000) and bool(torch.isfinite(on_card).all()),
          f"logits {tuple(on_card.shape)} not finite (2, 1000)")
    max_abs = float((on_card - on_cpu).abs().max())
    scale = float(on_cpu.abs().max())
    same_top1 = bool((on_card.argmax(-1) == on_cpu.argmax(-1)).all())
    print(f"\nparity: card vs CPU forward (batch 2, {cpu_s:.1f}s on CPU): "
          f"max|diff| {max_abs:.3e}, max|logit| {scale:.3e}, "
          f"ratio {max_abs / scale:.3e}, same top-1 {same_top1}")
    check(max_abs <= LOGIT_REL_TOL * scale,
          f"logits differ by {max_abs:.3e} > {LOGIT_REL_TOL} * {scale:.3e}")
    check(same_top1, "top-1 differs between the card and the CPU")


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 1
    card, device = header()
    rows = kernel_signatures(device)
    engine, launches = serving(device)

    def per_forward(key):
        return sum(r[key] * r["count"] for r in rows)

    breakdown(engine, per_forward("ms"))
    parity(engine)

    bound_by = {}
    for r in rows:
        bound_by[r["bound_by"]] = (bound_by.get(r["bound_by"], 0.0)
                                   + r["bound_ms"] * r["count"])
    kernels = [{
        "name": "conv2d_direct",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_direct.cu",
        "replaces": "src/repro/kernels/conv2d_direct.py:295",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows),
        "ms": per_forward("ms"),
        "plain_ms": per_forward("plain_ms"),
        "bound_ms": per_forward("bound_ms"),
        "bound_by": max(bound_by, key=bound_by.get),
        "library_ms": per_forward("library_ms"),
        "per": f"the 52 K1 convs of one ResNet-50 forward, batch {BATCH}, "
               f"{IMAGE}x{IMAGE}",
        "card": card,
    }]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
