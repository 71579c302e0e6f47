"""The paper's §II-H kernel streams, end to end on one convolution:

  blocking -> ``core.blocking.conv_blocking`` (kind "streams"; the tuner's
              winner when ``REPRO_AUTOTUNE`` is on)
  dryrun   -> record the offset and flag streams and their RLE segments
  replay   -> K4 executes the schedule (the CUDA kernel on the card, its
              plain PyTorch version with ``--device cpu``)

    PYTHONPATH=src python -m repro_torch.launch.streams_demo [--device cpu]

It prints the blocking, the dryrun's step and segment counts, whether the
§II-E prefetch property holds, and the replay's max error against
``kernels.ref.conv2d_fused``.
"""
from __future__ import annotations

import argparse
import math

import numpy as np
import torch

from repro_torch.backend import resolve_device
from repro_torch.core.blocking import conv_blocking
from repro_torch.core.streams import build_conv_schedule, prefetch_streams
from repro_torch.kernels import conv2d_streams as k4
from repro_torch.kernels import ref

N, H, C, K, R, STRIDE, PAD = 2, 16, 16, 32, 3, 1, 1


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu (the plain version)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((N, H, H, C)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((R, R, C, K)) * 0.1)
                         .astype(np.float32))
    bias = torch.from_numpy(rng.standard_normal(K).astype(np.float32))
    x, w, bias = x.to(device), w.to(device), bias.to(device)

    blk = conv_blocking(h=H, w=H, c=C, k=K, r=R, s=R, stride=STRIDE,
                        padding=PAD, kind="streams", backend=device.type,
                        minibatch=N)
    p = (H + 2 * PAD - R) // STRIDE + 1
    print(f"blocking: rb_p={blk.rb_p} k_blk={blk.k_blk} c_blk={blk.c_blk} "
          f"order={blk.order} (working set {blk.vmem_bytes / 1024:.0f} KiB)")

    # --- dryrun -------------------------------------------------------------
    k_blk, c_blk = min(K, 8), min(C, 8)   # small blocks for the demo
    rb_p = min(blk.rb_p, p)
    sched = build_conv_schedule(
        n=N, k_b=K // k_blk, p_b=math.ceil(p / rb_p), c_b=C // c_blk,
        order=blk.order, relu=True)
    print(f"dryrun: {len(sched)} microkernel invocations, "
          f"{len(sched.segments)} RLE segments")
    pn, pk, pp, pc = prefetch_streams(sched)
    prefetch_ok = bool((pn[:-1] == sched.n_ids[1:]).all()
                       and (pk[:-1] == sched.kb_ids[1:]).all()
                       and (pp[:-1] == sched.pb_ids[1:]).all()
                       and (pc[:-1] == sched.cb_ids[1:]).all())
    print(f"prefetch property holds: {prefetch_ok}")

    # --- replay -------------------------------------------------------------
    before = k4.launches
    out = k4.conv2d_streams(x, w, schedule=sched, stride=STRIDE, padding=PAD,
                            bias=bias, rb_p=rb_p, k_blk=k_blk, c_blk=c_blk)
    expect = ref.conv2d_fused(x, w, stride=STRIDE, padding=PAD, bias=bias,
                              relu=True)
    err = float((out - expect).abs().max())
    print(f"replay on {device.type} ({k4.launches - before} kernel "
          f"launches) matches the fused reference: max err = {err:.2e}")
    return dict(blocking=blk, steps=len(sched),
                segments=len(sched.segments), prefetch_ok=prefetch_ok,
                max_err=err, launches=k4.launches - before)


if __name__ == "__main__":
    main()
