"""CNN inference serving over the GxM executor, the port's counterpart of
``repro/graph/serving.py``, on one device.

* **Bucketed batching** — requests are padded to a small fixed ladder of
  batch sizes, so the set of shapes every kernel sees is finite.
* **Warmup** — ``CnnInferenceEngine.warmup`` tunes the kernel plan of
  every lane-aligned conv signature x bucket batch into the persistent
  cache (``repro_torch.tune``: K1's under "fwd", K3's under "q8"), then
  runs one forward per bucket, so the kernels build and load before the
  first request arrives.
* **Tuned plans** — every request runs under the engine's ``autotune``
  mode ("cache" by default, as in the reference): each K1 or K3 launch
  takes the plan warmup tuned for its shape and bucket, or the kernel's
  default plan on a miss.
* **int8** (§II-K) — a quantized engine calibrates per-conv activation
  scales at warmup and serves the int8 params tree through K3.

No mesh yet.  ``launch/serve_cnn.py`` builds the request queue on top.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from repro_torch import backend as be
from repro_torch import tune
from repro_torch.core.conv import lane_ok
from repro_torch.core.quantize import calibrate_network, quantize_gxm_params
from repro_torch.graph.etg import quantize_etg

# calibration's synthetic warmup batches (the reference's defaults)
CALIB_BATCHES, CALIB_BATCH = 2, 4


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
    no cross-batch ops (BN folded from running stats, activation scales
    fixed at calibration), so padded lanes cannot perturb real ones.

    ``quantized`` (§II-K int8 serving): ``None`` follows the GxM (whose own
    default is ``REPRO_QUANTIZE``); ``True`` on an f32 GxM re-marks its ETG
    in place.  ``params`` stays the f32 tree, on which calibration runs;
    the quantized tree the request path serves (``qparams``) is derived by
    ``calibrate``, which ``warmup`` calls first.

    ``autotune`` is the mode scoped around every forward (``infer`` and
    warmup's forwards): "cache" (default) takes the plans warmup persisted,
    the kernels' default plans on a miss; None defers to the global
    ``REPRO_AUTOTUNE`` knob.
    """

    def __init__(self, gxm, params, *, image_hw=(224, 224),
                 max_batch: int = 32, buckets=None,
                 quantized: bool | None = None,
                 autotune: str | None = "cache"):
        if autotune is not None:
            be.resolve_autotune(autotune)           # validate
        self.autotune = autotune
        self.gxm = gxm
        self.params = params
        self.device = gxm.device
        self.image_hw = tuple(image_hw)
        self.buckets = round_buckets(buckets, 1) if buckets \
            else make_buckets(max_batch)
        if quantized is None:
            quantized = bool(getattr(gxm, "quantized", False))
        elif quantized and not getattr(gxm, "quantized", False):
            quantize_etg(gxm.etg)
            gxm.quantized = True
        self.quantized = quantized
        self.qparams = None
        self.act_scales = None

    def conv_shapes(self) -> list[dict]:
        return conv_shapes(self.gxm.etg, self.image_hw)

    @property
    def _run_params(self):
        """The params tree the request path runs: the quantized tree on a
        quantized engine, the f32 tree otherwise.  A quantized engine that
        has not been calibrated raises rather than serve f32."""
        if not self.quantized:
            return self.params
        if self.qparams is None:
            raise ValueError("quantized engine is not calibrated: call "
                             "warmup() or calibrate() first")
        return self.qparams

    def calibrate(self, *, seed: int = 0) -> dict:
        """Calibrate per-conv activation scales and build the quantized
        params tree (``core.quantize``) on ``CALIB_BATCHES`` synthetic
        batches of ``CALIB_BATCH`` images from
        ``np.random.default_rng(seed)``, the same draws as the reference's
        defaults, so calibration is deterministic for a seed.  Returns the
        scale dict."""
        if not self.quantized:
            raise ValueError("calibrate() on an engine that is not quantized")
        rng = np.random.default_rng(seed)
        images = [rng.standard_normal(
            (CALIB_BATCH, *self.image_hw, 3)).astype(np.float32)
            for _ in range(CALIB_BATCHES)]
        self.act_scales = calibrate_network(self.gxm, self.params, images)
        self.qparams = quantize_gxm_params(self.gxm.etg, self.params,
                                           self.act_scales)
        return self.act_scales

    def _autotune_scope(self):
        if self.autotune is None:
            return contextlib.nullcontext()
        return be.use_autotune(self.autotune)

    def warmup(self, *, autotune: str = "tune", cache=None) -> dict:
        """Pre-fill what a request would otherwise fall into:

        1. the persistent plan cache (``repro_torch.tune``) for every
           distinct conv signature x bucket batch, under kind "fwd", or
           "q8" at 1 byte an element on a quantized engine (calibrated
           first), by ``tune.warmup_convs`` in mode ``autotune`` ("tune":
           tune on a miss; "cache": report what is there; "off": skip);
           only lane-aligned signatures are tuned, the rest reported;
        2. one forward per bucket under the engine's own ``autotune``
           scope, which the request path runs under, so every kernel and
           plan it launches is built and loaded.

        ``cache`` overrides the tuning store (tests, inspection); the
        forwards read the process default cache (``REPRO_TUNE_CACHE``).
        Returns a report: signature counts, ``tune_entries`` (the cached
        plans), the conv input strategy (``backend.get_conv_tiling``),
        whether the engine serves int8, and the warmup seconds per
        bucket."""
        if self.quantized and self.qparams is None:
            self.calibrate()          # deterministic synthetic batches
        sigs = distinct_conv_signatures(self.conv_shapes())
        report = {
            "conv_signatures": len(sigs),
            "kernel_path_signatures":
                sum(1 for s in sigs if lane_ok(s["c"], s["k"])),
            "kernel_cache_entries": len(self.gxm.etg.kernel_cache),
            "buckets": list(self.buckets),
            "tune_entries": 0,
            "conv_tiling": be.get_conv_tiling(),
            "quantized": self.quantized,
            "warmup_s": {},
        }
        if be.resolve_autotune(autotune) != "off":
            kind = "q8" if self.quantized else "fwd"
            entries = tune.warmup_convs(
                sigs, minibatches=tuple(self.buckets), kinds=(kind,),
                mode=autotune, backend=self.device.type, cache=cache,
                dtype_bytes=tune.plan_dtype_bytes(kind))
            report["tune_entries"] = sum(1 for e in entries if e["cached"])
        for bucket in self.buckets:
            t0 = time.perf_counter()
            x = torch.zeros((bucket, *self.image_hw, 3), device=self.device)
            with self._autotune_scope():
                self.gxm.infer(self._run_params, x)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            report["warmup_s"][bucket] = time.perf_counter() - t0
        return report

    def infer(self, images):
        """Logits for ``images`` (n, H, W, 3), numpy or tensor; pads n up to
        the minimal bucket and returns the (n, classes) real lanes on the
        engine's device, under the engine's ``autotune`` scope."""
        x = torch.as_tensor(images, dtype=torch.float32,
                            device=self.device)
        n = x.shape[0]
        bucket = pick_bucket(n, self.buckets)
        if n < bucket:
            x = torch.cat([x, x.new_zeros((bucket - n, *x.shape[1:]))])
        with self._autotune_scope():
            return self.gxm.infer(self._run_params, x.contiguous())[:n]
