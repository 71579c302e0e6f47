"""CNN inference serving over the GxM executor, the port's counterpart of
``repro/graph/serving.py``, on one device.

* **Bucketed batching** — requests are padded to a small fixed ladder of
  batch sizes, so the set of shapes every kernel sees is finite.
* **Warmup** — ``CnnInferenceEngine.warmup`` runs one forward per bucket, so
  the kernels build and load before the first request arrives.

No mesh, no autotuner and no int8 yet: those come with later slices.
``launch/serve_cnn.py`` builds the request queue on top.
"""
from __future__ import annotations

import time

import torch

from repro_torch.core.conv import lane_ok


def _out(dim: int, f: int, stride: int, padding: int) -> int:
    return (dim + 2 * padding - f) // stride + 1


def conv_shapes(etg, image_hw) -> list[dict]:
    """Per-conv-task shapes, inferred by walking the ETG from the network
    input size.  Returns one dict per conv task (h/w are the conv's *input*
    plane) with its dedup ``kernel_id``."""
    h0, w0 = image_hw
    hw: dict[str, tuple | None] = {"input": (h0, w0)}
    shapes = []
    for t in etg.tasks:
        a = t.attrs
        if t.op == "input":
            hw[t.name] = (h0, w0)
            continue
        src = hw.get(t.inputs[0]) if t.inputs else None
        if t.op == "conv":
            h, w = src
            shapes.append(dict(name=t.name, h=h, w=w, c=a["c"], k=a["k"],
                               r=a["r"], s=a["s"], stride=a["stride"],
                               padding=a["padding"],
                               kernel_id=a.get("kernel_id")))
            res = (_out(h, a["r"], a["stride"], a["padding"]),
                   _out(w, a["s"], a["stride"], a["padding"]))
        elif t.op == "maxpool":
            h, w = src
            res = (_out(h, a["window"], a["stride"], a["padding"]),
                   _out(w, a["window"], a["stride"], a["padding"]))
        elif t.op in ("avgpool", "fc"):
            res = None                      # rank-2 from here on
        else:                               # bn / relu / add / split / concat
            res = src
        hw[t.name] = res
        if "output_name" in a:
            hw[a["output_name"]] = res
    return shapes


def distinct_conv_signatures(shapes: list[dict]) -> list[dict]:
    """Dedup conv shapes down to their (h, w, c, k, r, s, stride, padding)."""
    seen, out = set(), []
    for sh in shapes:
        sig = (sh["h"], sh["w"], sh["c"], sh["k"], sh["r"], sh["s"],
               sh["stride"], sh["padding"])
        if sig in seen:
            continue
        seen.add(sig)
        out.append({f: sh[f] for f in ("h", "w", "c", "k", "r", "s",
                                       "stride", "padding")})
    return out


def cnn_model_flops(etg, image_hw, batch: int) -> float:
    """Useful model FLOPs of one inference forward: 2·P·Q·K·C·R·S per conv
    plus 2·C·K for the classifier."""
    total = 0.0
    for sh in conv_shapes(etg, image_hw):
        p = _out(sh["h"], sh["r"], sh["stride"], sh["padding"])
        q = _out(sh["w"], sh["s"], sh["stride"], sh["padding"])
        total += 2.0 * p * q * sh["k"] * sh["c"] * sh["r"] * sh["s"]
    for t in etg.tasks:
        if t.op == "fc":
            total += 2.0 * t.attrs["c"] * t.attrs["k"]
    return total * batch


# -- bucketing ---------------------------------------------------------------

def round_buckets(buckets, num_shards: int) -> tuple[int, ...]:
    """Round every rung up to the next multiple of ``num_shards`` (dedup'd,
    sorted); the port serves on one device, so ``num_shards`` is 1 there."""
    assert num_shards >= 1
    rounded = {-(-int(b) // num_shards) * num_shards for b in buckets}
    assert all(b >= 1 for b in rounded), buckets
    return tuple(sorted(rounded))


def make_buckets(max_batch: int) -> tuple[int, ...]:
    """Geometric bucket ladder 1, 2, 4, ... up to the first power of two
    >= max_batch."""
    assert max_batch >= 1
    b, out = 1, []
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(b)
    return tuple(out)


def pick_bucket(n: int, buckets) -> int:
    """Smallest bucket that fits ``n`` requests (minimal padding).  A batch
    beyond the largest bucket raises; callers chunk first."""
    for b in sorted(buckets):
        if b >= n:
            return b
    raise ValueError(f"batch {n} exceeds largest bucket {max(buckets)}; "
                     f"chunk it first")


class CnnInferenceEngine:
    """Bucketed, warmup-able inference front-end for one GxM model on its
    device.

    ``infer(images)`` pads the batch with zero images to the minimal bucket,
    runs the forward and returns only the real lanes' logits.  Inference has
    no cross-batch ops (BN folded from running stats), so padded lanes
    cannot perturb real ones.
    """

    def __init__(self, gxm, params, *, image_hw=(224, 224),
                 max_batch: int = 32, buckets=None):
        self.gxm = gxm
        self.params = params
        self.device = gxm.device
        self.image_hw = tuple(image_hw)
        self.buckets = round_buckets(buckets, 1) if buckets \
            else make_buckets(max_batch)

    def conv_shapes(self) -> list[dict]:
        return conv_shapes(self.gxm.etg, self.image_hw)

    def warmup(self) -> dict:
        """One forward per bucket, so every kernel the request path launches
        is built and loaded first.  Returns a report: signature counts and
        the warmup seconds per bucket."""
        sigs = distinct_conv_signatures(self.conv_shapes())
        report = {
            "conv_signatures": len(sigs),
            "kernel_path_signatures":
                sum(1 for s in sigs if lane_ok(s["c"], s["k"])),
            "kernel_cache_entries": len(self.gxm.etg.kernel_cache),
            "buckets": list(self.buckets),
            "warmup_s": {},
        }
        for bucket in self.buckets:
            t0 = time.perf_counter()
            x = torch.zeros((bucket, *self.image_hw, 3), device=self.device)
            self.gxm.infer(self.params, x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            report["warmup_s"][bucket] = time.perf_counter() - t0
        return report

    def infer(self, images):
        """Logits for ``images`` (n, H, W, 3), numpy or tensor; pads n up to
        the minimal bucket and returns the (n, classes) real lanes on the
        engine's device."""
        x = torch.as_tensor(images, dtype=torch.float32,
                            device=self.device)
        n = x.shape[0]
        bucket = pick_bucket(n, self.buckets)
        if n < bucket:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        return self.gxm.infer(self.params, x.contiguous())[:n]
