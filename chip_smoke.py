#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root, one GPU

Phases, each of which fails the run (nonzero exit, no result line):

1. Header: the card's name and power limit, torch and CUDA versions, the
   TF32 flags, and the build of every CUDA kernel from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together), with each build's
   seconds and its ptxas register and spill lines.
2. K1 vs plain, serving: every distinct lane-aligned (shape, fused
   epilogue) signature of ResNet-50 at 224x224, batch 16, on random
   weights, BN scale, shift and residual: K1 against its plain PyTorch
   version (max |diff| / max |plain| <= 1e-5), with CUDA-event times of K1,
   the plain version and the library yardstick (cuDNN ``F.conv2d`` in true
   f32 plus the epilogue), and the bound (the larger of FLOPs / 67 TFLOP/s
   f32 and bytes / 3.35 TB/s).
3. Serving: full ResNet-50 (1000 classes, 224x224) with random BN running
   statistics through ``CnnInferenceEngine`` and ``ImageServer`` at
   max_batch 16: an untimed pass of 64 requests, then a window of 512
   requests in bursts that reach every bucket (1 to 16), with every image
   made before the window opens.  Images/s is over the window's wall time;
   p50/p99 are enqueue-to-result.  K1's launch count is reset just before
   the window and read just after: it must be 52 per forward.  Then the
   time of one batch-16 step by host clock: the copy to the card, the
   forward, and K1's share.
4. Serving parity: a batch of 2 images on the card against the port's CPU
   forward (the plain versions): max |diff| <= 1e-4 * max |logit| and the
   same top-1 on every image.
5. K1 in training: every distinct lane-aligned signature one ResNet-50
   training step at batch 32 launches on K1, the bare forwards and the
   backward-data dual convs of ``dual_conv_signatures`` (31 distinct, 61
   launches), against the plain version (<= 1e-5), with times, the cuDNN
   yardstick and the bound.
6. K2 vs plain: the 22 distinct lane-aligned weight-update signatures of
   ResNet-50 at batch 32 (<= 1e-5), with the kernel's ``splits``, times,
   the bound, and the library yardstick: cuDNN's f32 weight gradient
   (``aten.convolution_backward``, output mask [False, True, False], TF32
   off), which the port never calls.
7. Training: full ResNet-50 (224x224, 1000 classes, batch 32, lr 0.1)
   through ``launch.train_cnn.build_trainer`` on ``SyntheticImageData``
   batches put on the card before timing: 2 untimed steps, 10 timed steps
   (median step ms, images/s, every loss finite), one step with the launch
   counts set to 0 just before it and read just after (K1 = forward +
   dual launches, K2 = one per lane-aligned conv, both derived from the
   port's ETG), then 3 steps under ``torch.profiler``: device time by
   kernel, the device's busy and idle share, K1 and K2 per step.
8. Training parity: one step of full ResNet-50 at batch 2 on the card
   against the same step on the port's CPU path (the plain versions) from
   the same params and batch: the loss within 1e-4 relative; every
   trainable leaf's update (old - new) / lr, and the change of every
   running mean and variance, within 1e-3 * max |CPU|.  ReLU and max-pool
   are discontinuous: a pre-activation within f32 rounding of zero, or two
   pooled values within rounding of each other, may be decided differently
   by two summation orders, and then a whole pixel's gradient moves.  So
   the CPU step takes the card's ReLU masks and max-pool choices, and the
   script prints how many of them the CPU would have decided otherwise.
9. The kernels line, then the device line last.

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
TRAIN_BATCH = 32            # torchvision's ResNet-50 recipe, per GPU
TRAIN_LR = 0.1
PARITY_BATCH = 2
F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12   # H100 SXM HBM3
KERNEL_REL_TOL = 1e-5
LOGIT_REL_TOL = 1e-4
LOSS_REL_TOL = 1e-4
UPDATE_REL_TOL = 1e-3
PINNED_SHARE_TOL = 1e-5     # ReLU / max-pool decisions the CPU takes from the card


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
    t0 = time.perf_counter()
    seconds = _build.build_all()
    print(f"kernel build: {len(seconds)} sources in parallel in "
          f"{time.perf_counter() - t0:.1f}s")
    for name, sec in seconds.items():
        print(f"  {name}: {sec:.1f}s")
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print("    ptxas:", line.strip())
    return smi[0], device


def bound(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take, ms, and what bounds it."""
    t_ops = flops / F32_PEAK_FLOPS * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


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
        bound_ms, bound_by = bound(flops, nbytes)
        rec = dict(h=h, w=w, c=c, k=k, r=r, stride=st, fused=list(fused),
                   count=count, max_rel_err=max_rel, max_abs_err=max_abs,
                   ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                   bound_ms=bound_ms, bound_by=bound_by, flops=flops)
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


def training_signatures(etg):
    """The kernel launches of one ResNet-50 training step at IMAGE x IMAGE,
    from the port's ETG: distinct K1 forward, K1 dual and K2 signatures,
    each with how many launches of one step share it."""
    from repro_torch.core.conv import lane_ok
    from repro_torch.core.duality import dual_conv_signatures
    from repro_torch.graph.serving import conv_shapes

    reads = {t.name: t.inputs[0] for t in etg.tasks if t.op == "conv"}
    fwd: dict[tuple, int] = {}
    dual: dict[tuple, int] = {}
    wu: dict[tuple, int] = {}

    def add(table, key):
        table[key] = table.get(key, 0) + 1

    for sh in conv_shapes(etg, (IMAGE, IMAGE)):
        if not lane_ok(sh["c"], sh["k"]):
            continue
        geo = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"])
        add(fwd, geo)
        add(wu, geo)
        if reads[sh["name"]] == "input":     # the image needs no gradient
            continue
        for d in dual_conv_signatures(
                r=sh["r"], s=sh["s"], c=sh["c"], k=sh["k"],
                stride=sh["stride"], padding=sh["padding"],
                input_hw=(sh["h"], sh["w"]), unique=False):
            if lane_ok(d["c"], d["k"]):
                add(dual, (d["h"], d["w"], d["c"], d["k"], d["r"], d["s"],
                           d["stride"], d["padding"]))
    return fwd, dual, wu


def train_k1_signatures(device, fwd, dual):
    """Phase 5: K1 on every bare forward and dual signature of a training
    step at TRAIN_BATCH.  Returns records with ``role`` and ``count``."""
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import ref

    gen = torch.Generator(device=device).manual_seed(SEED + 5)
    rows = []
    print(f"\nK1 in training, batch {TRAIN_BATCH}: {len(fwd)} forward "
          f"signatures ({sum(fwd.values())} launches), {len(dual)} dual "
          f"({sum(dual.values())} launches), bare conv:")
    print("  role   h   w    c    k r s st pad count  max_rel    max_abs"
          "        ms  plain_ms  library_ms  bound_ms bound_by")
    for role, table in (("fwd", fwd), ("dual", dual)):
        for (h, w, c, k, r, s, st, pad), count in table.items():
            p = (h + 2 * pad - r) // st + 1
            q = (w + 2 * pad - s) // st + 1
            x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen,
                            device=device)
            wt = torch.randn((r, s, c, k), generator=gen, device=device) \
                * math.sqrt(2.0 / (r * s * c))
            args = dict(x=x, w=wt, stride=st, padding=pad)
            out = k1.conv2d_direct(**args)
            plain = k1.conv2d_direct_plain(**args)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(out).all()),
                  f"K1 non-finite at {role} {h, c, k, r, s}")
            max_abs = float((out - plain).abs().max())
            max_rel = max_abs / float(plain.abs().max())
            ms = cuda_ms(lambda: k1.conv2d_direct(**args), 20)
            plain_ms = cuda_ms(lambda: k1.conv2d_direct_plain(**args), 5)
            library_ms = cuda_ms(lambda: ref.conv2d(**args), 20)
            flops = 2.0 * TRAIN_BATCH * p * q * k * c * r * s
            nbytes = 4.0 * (TRAIN_BATCH * (h * w * c + p * q * k)
                            + r * s * c * k)
            bound_ms, bound_by = bound(flops, nbytes)
            rows.append(dict(role=role, h=h, w=w, c=c, k=k, r=r, s=s,
                             stride=st, padding=pad, count=count,
                             max_rel_err=max_rel, max_abs_err=max_abs, ms=ms,
                             plain_ms=plain_ms, library_ms=library_ms,
                             bound_ms=bound_ms, bound_by=bound_by))
            print(f"  {role:5s}{h:4d}{w:4d}{c:5d}{k:5d}{r:2d}{s:2d}{st:3d}"
                  f"{pad:4d}{count:6d}  {max_rel:.2e}  {max_abs:.2e} "
                  f"{ms:9.4f} {plain_ms:9.4f} {library_ms:11.4f} "
                  f"{bound_ms:9.4f} {bound_by}")
            check(max_rel <= KERNEL_REL_TOL,
                  f"K1 disagrees with its plain version at {role} "
                  f"{(h, c, k, r, s, st, pad)}: max_rel {max_rel:.3e} > "
                  f"{KERNEL_REL_TOL}")
            del x, wt, args, out, plain
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def wu_signatures(device, wu):
    """Phase 6: K2 against its plain version on every weight-update
    signature of a training step at TRAIN_BATCH."""
    import torch
    from repro_torch.kernels import conv2d_wu as k2

    gen = torch.Generator(device=device).manual_seed(SEED + 6)
    rows = []
    print(f"\nK2 vs plain, ResNet-50 {IMAGE}x{IMAGE} batch {TRAIN_BATCH} "
          f"({len(wu)} signatures, {sum(wu.values())} convs):")
    print("  h   w    c    k r st pad count tile splits chunk  max_rel"
          "    max_abs        ms  plain_ms  library_ms  bound_ms bound_by")
    for (h, w, c, k, r, s, st, pad), count in wu.items():
        p = (h + 2 * pad - r) // st + 1
        q = (w + 2 * pad - s) // st + 1
        x = torch.randn((TRAIN_BATCH, h, w, c), generator=gen, device=device)
        do = torch.randn((TRAIN_BATCH, p, q, k), generator=gen,
                         device=device)
        args = dict(x=x, do=do, stride=st, padding=pad, filter_rs=(r, s))
        plan = k2.plan(n=TRAIN_BATCH, p=p, q=q, c=c, k=k, r=r, s=s)
        out = k2.conv2d_wu(**args)
        plain = k2.conv2d_wu_plain(**args)
        torch.cuda.synchronize()
        check(bool(torch.isfinite(out).all()), f"K2 non-finite at {h, c, k}")
        max_abs = float((out - plain).abs().max())
        max_rel = max_abs / float(plain.abs().max())
        # cuDNN's weight gradient on the same NHWC tensors (channels-last
        # views), TF32 off: the yardstick, never called by the port
        x_nchw, do_nchw = x.permute(0, 3, 1, 2), do.permute(0, 3, 1, 2)
        w_shape = torch.empty((k, c, r, s), device=device).to(
            memory_format=torch.channels_last)

        def library():
            with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
                return torch.ops.aten.convolution_backward(
                    do_nchw, x_nchw, w_shape, None, [st, st], [pad, pad],
                    [1, 1], False, [0, 0], 1, [False, True, False])[1]
        lib_abs = float((library().permute(2, 3, 1, 0) - plain).abs().max())
        ms = cuda_ms(lambda: k2.conv2d_wu(**args), 20)
        plain_ms = cuda_ms(lambda: k2.conv2d_wu_plain(**args), 5)
        library_ms = cuda_ms(library, 20)
        flops = 2.0 * TRAIN_BATCH * p * q * k * c * r * s
        nbytes = 4.0 * (TRAIN_BATCH * (h * w * c + p * q * k) + r * s * c * k)
        bound_ms, bound_by = bound(flops, nbytes)
        rows.append(dict(h=h, w=w, c=c, k=k, r=r, s=s, stride=st,
                         padding=pad, count=count, tile=plan.tile,
                         splits=plan.splits, chunk=plan.chunk,
                         max_rel_err=max_rel, max_abs_err=max_abs,
                         library_rel_err=lib_abs / float(plain.abs().max()),
                         ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                         bound_ms=bound_ms, bound_by=bound_by))
        print(f"{h:3d}{w:4d}{c:5d}{k:5d}{r:2d}{st:3d}{pad:4d}{count:6d}"
              f"{plan.tile:5d}{plan.splits:7d}{plan.chunk:6d}  {max_rel:.2e}"
              f"  {max_abs:.2e} {ms:9.4f} {plain_ms:9.4f} {library_ms:11.4f}"
              f" {bound_ms:9.4f} {bound_by}")
        check(max_rel <= KERNEL_REL_TOL,
              f"K2 disagrees with its plain version at {(h, c, k, r, st)}: "
              f"max_rel {max_rel:.3e} > {KERNEL_REL_TOL}")
        del x, do, args, out, plain, x_nchw, do_nchw
    print("  per-signature JSON:", json.dumps(rows))
    return rows


def _device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        value = getattr(evt, attr, None)
        if value is not None:
            return float(value)
    return 0.0


def profile_steps(step, params, batches) -> dict:
    """Device time by kernel name and the device's busy share over
    ``len(batches)`` training steps under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.autograd.DeviceType.CUDA
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            params, _ = step(params, batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    steps = len(batches)
    by_name = sorted(((_device_us(e) / 1e3 / steps, e.count / steps, e.key)
                      for e in prof.key_averages() if e.device_type == cuda),
                     reverse=True)
    device_ms = sum(ms for ms, _, _ in by_name)
    # busy share: the union of device intervals over the span from the
    # first device event to the last
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == cuda)
    busy_us = 0.0
    if spans:
        cur_s, cur_e = spans[0]
        for s, e in spans[1:]:
            if s > cur_e:
                busy_us += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy_us += cur_e - cur_s
    span_us = spans[-1][1] - spans[0][0] if spans else 0.0

    def named(needle):
        return sum(ms for ms, _, name in by_name if needle in name)
    out = dict(wall_ms_per_step=wall_ms / steps, device_ms_per_step=device_ms,
               device_busy_share=busy_us / span_us if span_us else None,
               k1_ms_per_step=named("conv2d_direct_kernel"),
               k2_ms_per_step=named("conv2d_wu_kernel") + named("wu_reduce"),
               k2_reduce_ms_per_step=named("wu_reduce"),
               top=[dict(ms=ms, launches=n, name=name[:120])
                    for ms, n, name in by_name[:15]])
    print(f"  profile of {steps} steps: {out['wall_ms_per_step']:.3f} ms/step "
          f"by host clock under the profiler, device {device_ms:.3f} ms/step "
          f"over {len(by_name)} kernel names")
    if device_ms == 0.0 or not span_us:
        print("  profiler: key_averages() shows no device time; the CUDA-"
              "event numbers of phases 5 and 6 stand alone")
        return out
    print(f"  device busy share {out['device_busy_share']:.4f}, idle "
          f"{1 - out['device_busy_share']:.4f} (first to last device event)")
    print(f"  K1 {out['k1_ms_per_step']:.3f} ms/step, K2 "
          f"{out['k2_ms_per_step']:.3f} ms/step (its reduction "
          f"{out['k2_reduce_ms_per_step']:.3f}), by kernel name")
    for rec in out["top"]:
        print(f"    {rec['ms']:9.3f} ms  x{rec['launches']:6.1f}  "
              f"{rec['name']}")
    return out


def training(device, fwd, dual, wu):
    """Phase 7: the training main path.  Returns (launch counts of one
    step, summary)."""
    import numpy as np
    import torch
    from repro_torch.kernels import conv2d_direct as k1
    from repro_torch.kernels import conv2d_wu as k2
    from repro_torch.launch.train_cnn import build_trainer
    from repro_torch.train.step import to_device

    gxm, params, step, data = build_trainer(
        full=True, num_classes=1000, image=IMAGE, batch=TRAIN_BATCH,
        lr=TRAIN_LR, device=device, seed=SEED)
    check(gxm.num_classes == 1000 and len(
        [t for t in gxm.etg.tasks if t.op == "conv"]) == 53,
        "not the full ResNet-50")
    batches = [to_device(data.batch_at(i), device) for i in range(16)]
    torch.cuda.synchronize()
    print(f"\ntraining: ResNet-50 {IMAGE}x{IMAGE}, 1000 classes, batch "
          f"{TRAIN_BATCH}, lr {TRAIN_LR}, SyntheticImageData (16 batches "
          f"on the card before timing)")
    losses = []
    t0 = time.perf_counter()
    for batch in batches[:2]:
        params, loss = step(params, batch)
        losses.append(float(loss))
    print(f"  2 untimed steps in {time.perf_counter() - t0:.2f}s, losses "
          f"{losses}")
    times = []
    for batch in batches[2:12]:
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        params, loss = step(params, batch)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(loss))
    step_ms = float(np.median(times))
    print(f"  10 timed steps: median {step_ms:.3f} ms/step (min "
          f"{min(times):.3f}, max {max(times):.3f}), "
          f"{TRAIN_BATCH / step_ms * 1e3:.2f} images/s")
    print(f"  losses: {[round(v, 4) for v in losses]}")
    check(all(math.isfinite(v) for v in losses), f"non-finite loss {losses}")

    expect_k1 = sum(fwd.values()) + sum(dual.values())
    expect_k2 = sum(wu.values())
    k1.launches = k2.launches = 0
    params, loss = step(params, batches[12])
    torch.cuda.synchronize()
    counts = {"conv2d_direct": k1.launches, "conv2d_wu": k2.launches}
    print(f"  launches in one step: K1 {counts['conv2d_direct']} (expected "
          f"{sum(fwd.values())} forward + {sum(dual.values())} dual = "
          f"{expect_k1}), K2 {counts['conv2d_wu']} (expected {expect_k2})")
    check(counts["conv2d_direct"] == expect_k1 == 113,
          f"K1 launched {counts['conv2d_direct']} times in a step, expected "
          f"{expect_k1} (113)")
    check(counts["conv2d_wu"] == expect_k2 == 52,
          f"K2 launched {counts['conv2d_wu']} times in a step, expected "
          f"{expect_k2} (52)")
    prof = profile_steps(step, params, batches[13:16])
    return counts, dict(step_ms=step_ms, step_times_ms=times,
                        images_per_s=TRAIN_BATCH / step_ms * 1e3,
                        losses=losses, profile=prof)


def train_parity(device):
    """Phase 8: one training step on the card against the port's CPU
    step, with the CPU taking the card's ReLU masks and max-pool choices."""
    import torch
    import torch.nn.functional as F
    from repro_torch.data.pipeline import SyntheticImageData
    from repro_torch.graph import GxM, executor, resnet50
    from repro_torch.train.step import to_device

    on_card = GxM(resnet50(), device=device)
    on_cpu = GxM(resnet50(), device="cpu")
    params = on_card.init(torch.Generator().manual_seed(SEED + 8))
    cpu_params = {name: {leaf: v.cpu() for leaf, v in p.items()}
                  for name, p in params.items()}
    batch = SyntheticImageData(hw=IMAGE, n_classes=1000,
                               global_batch=PARITY_BATCH,
                               seed=SEED + 8).batch_at(0)
    masks, pools = [], []
    relu, maxpool = executor._relu, executor._maxpool

    def record_relu(x):
        masks.append((x > 0).cpu())
        return relu(x)

    def record_pool(x, window, stride, padding):
        y, idx = F.max_pool2d(x.permute(0, 3, 1, 2), window, stride,
                              padding, return_indices=True)
        pools.append(idx.cpu())
        return y.permute(0, 2, 3, 1).contiguous()

    flips = dict(relu=0, relu_values=0, pool=0, pool_windows=0)
    replay_m, replay_p = iter(masks), iter(pools)

    def pinned_relu(x):
        m = next(replay_m)
        flips["relu"] += int((m != (x > 0)).sum())
        flips["relu_values"] += m.numel()
        return x * m

    def pinned_pool(x, window, stride, padding):
        idx = next(replay_p)
        xn = x.permute(0, 3, 1, 2)
        _, own = F.max_pool2d(xn, window, stride, padding,
                              return_indices=True)
        flips["pool"] += int((own != idx).sum())
        flips["pool_windows"] += idx.numel()
        y = xn.reshape(*xn.shape[:2], -1).gather(
            2, idx.reshape(*idx.shape[:2], -1)).reshape(idx.shape)
        return y.permute(0, 2, 3, 1).contiguous()

    try:
        executor._relu, executor._maxpool = record_relu, record_pool
        new_card, loss_card = on_card.sgd_train_step(
            params, to_device(batch, device), TRAIN_LR)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        executor._relu, executor._maxpool = pinned_relu, pinned_pool
        new_cpu, loss_cpu = on_cpu.sgd_train_step(
            cpu_params, to_device(batch, "cpu"), TRAIN_LR)
        cpu_s = time.perf_counter() - t0
    finally:
        executor._relu, executor._maxpool = relu, maxpool
    loss_rel = abs(float(loss_card) - float(loss_cpu)) / abs(float(loss_cpu))
    print(f"\ntraining parity: one step, batch {PARITY_BATCH}, card vs CPU "
          f"({cpu_s:.1f}s on CPU): loss {float(loss_card):.6f} vs "
          f"{float(loss_cpu):.6f}, rel {loss_rel:.3e}")
    print(f"  the CPU would have decided {flips['relu']} of "
          f"{flips['relu_values']} ReLU inputs and {flips['pool']} of "
          f"{flips['pool_windows']} max-pool windows otherwise (pinned to "
          f"the card's); limit {PINNED_SHARE_TOL} of each")
    check(flips["relu"] <= PINNED_SHARE_TOL * flips["relu_values"],
          f"{flips['relu']} of {flips['relu_values']} ReLU decisions differ "
          f"from the CPU's, more than {PINNED_SHARE_TOL} of them")
    check(flips["pool"] <= PINNED_SHARE_TOL * flips["pool_windows"],
          f"{flips['pool']} of {flips['pool_windows']} max-pool choices "
          f"differ from the CPU's, more than {PINNED_SHARE_TOL} of them")
    check(math.isfinite(float(loss_card)), "non-finite training loss")
    check(loss_rel <= LOSS_REL_TOL,
          f"loss differs by {loss_rel:.3e} > {LOSS_REL_TOL}")
    worst = (0.0, "")
    leaves = 0
    for name, p in cpu_params.items():
        for leaf, old in p.items():
            if leaf in executor.RUNNING_STATS:
                card = new_card[name][leaf].cpu() - old
                cpu = new_cpu[name][leaf] - old
            else:
                card = (old - new_card[name][leaf].cpu()) / TRAIN_LR
                cpu = (old - new_cpu[name][leaf]) / TRAIN_LR
            err = float((card - cpu).abs().max())
            scale = float(cpu.abs().max())
            leaves += 1
            ratio = err / scale if scale else (0.0 if err == 0 else math.inf)
            worst = max(worst, (ratio, f"{name}.{leaf}"))
            check(err <= UPDATE_REL_TOL * scale,
                  f"{name}.{leaf}: update differs by {err:.3e} > "
                  f"{UPDATE_REL_TOL} * {scale:.3e}")
    print(f"  {leaves} leaves: worst max|diff| / max|CPU| {worst[0]:.3e} "
          f"({worst[1]}); limit {UPDATE_REL_TOL}")
    return dict(loss_rel=loss_rel, worst=worst, flips=flips)


def totals(rows) -> dict:
    """Per-pass sums over signature records (each time x its count), and
    what bounds most of the bound."""
    out = {key: sum(r[key] * r["count"] for r in rows)
           for key in ("ms", "plain_ms", "library_ms", "bound_ms")}
    by = {}
    for r in rows:
        by[r["bound_by"]] = by.get(r["bound_by"], 0.0) \
            + r["bound_ms"] * r["count"]
    out["bound_by"] = max(by, key=by.get)
    return out


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
    from repro_torch.graph import build_etg, resnet50

    t_start = time.perf_counter()
    card, device = header()
    rows = kernel_signatures(device)
    engine, serve_launches = serving(device)
    serve = totals(rows)
    breakdown(engine, serve["ms"])
    parity(engine)
    del engine
    torch.cuda.empty_cache()

    fwd, dual, wu = training_signatures(build_etg(resnet50()))
    check((sum(fwd.values()), sum(dual.values()), len(dual), len(wu)) ==
          (52, 61, 31, 22), "ResNet-50's training signatures are not the "
          "52 forward, 61 (31 distinct) dual and 22 weight-update ones")
    k1_rows = train_k1_signatures(device, fwd, dual)
    wu_rows = wu_signatures(device, wu)
    train_counts, summary = training(device, fwd, dual, wu)
    k1_fwd = totals([r for r in k1_rows if r["role"] == "fwd"])
    k1_dual = totals([r for r in k1_rows if r["role"] == "dual"])
    k2 = totals(wu_rows)
    print(f"  per step from the CUDA-event times x launches: K1 forward "
          f"{k1_fwd['ms']:.3f} ms + dual {k1_dual['ms']:.3f} ms, K2 "
          f"{k2['ms']:.3f} ms; of a {summary['step_ms']:.3f} ms step")
    summary["parity"] = train_parity(device)
    print(f"\nall phases in {time.perf_counter() - t_start:.1f}s")

    def timing(d):
        return {key: d[key] for key in ("ms", "plain_ms", "library_ms",
                                        "bound_ms", "bound_by")}
    kernels = [{
        "name": "conv2d_direct",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_direct.cu",
        "replaces": "src/repro/kernels/conv2d_direct.py:295",
        "launches": serve_launches + train_counts["conv2d_direct"],
        "launches_by_path": {"serving": serve_launches,
                             "training_step": train_counts["conv2d_direct"]},
        "max_abs_err": max(r["max_abs_err"] for r in rows + k1_rows),
        "max_rel_err": max(r["max_rel_err"] for r in rows + k1_rows),
        **timing(serve),
        "per": f"the 52 K1 convs of one ResNet-50 forward, batch {BATCH}, "
               f"{IMAGE}x{IMAGE}",
        "training": {"forward": timing(k1_fwd), "dual": timing(k1_dual),
                     "per": f"one ResNet-50 training step, batch "
                            f"{TRAIN_BATCH}: 52 bare forwards and 61 dual "
                            f"convs"},
        "card": card,
    }, {
        "name": "conv2d_wu",
        "route": "cuda",
        "source": "src/repro_torch/csrc/conv2d_wu.cu",
        "replaces": "src/repro/kernels/conv2d_wu.py:159",
        "launches": train_counts["conv2d_wu"],
        "max_abs_err": max(r["max_abs_err"] for r in wu_rows),
        "max_rel_err": max(r["max_rel_err"] for r in wu_rows),
        **timing(k2),
        "per": f"the 52 K2 launches of one ResNet-50 training step, batch "
               f"{TRAIN_BATCH}",
        "card": card,
    }]
    print(json.dumps({"training": {
        key: summary[key] for key in ("step_ms", "images_per_s", "losses")},
        "profile": {key: v for key, v in summary["profile"].items()
                    if key != "top"},
        "parity": summary["parity"]}))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
