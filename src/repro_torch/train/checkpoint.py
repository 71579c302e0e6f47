"""Checkpointing: atomic, integrity-checked, async-capable, elastic, the
port's copy of ``repro/train/checkpoint.py`` with its on-disk layout.

Layout:  <dir>/step_<N>/manifest.json + one .npy per leaf, the reference's:
  * leaves keyed by their dict keys joined by "/" (a bare leaf: ""), the
    files numbered in the sorted order of those keys; the manifest holds
    each leaf's file, shape, dtype and CRC32 of its bytes.  So a
    checkpoint the reference writes restores here, and one written here
    restores in the reference: this is how a train state crosses between
    the two packages (weights alone also cross by
    ``convert.params_from_jax``).  A bf16 leaf is stored as its ``uint16``
    bits (the view ``convert.to_tensor`` takes) under the dtype name
    "bfloat16", which is the name the reference records for its bf16
    leaves; their bytes and CRCs are the same;
  * atomic: written into ``.tmp-step_<N>`` then ``os.replace``d, so a
    crash never leaves a half checkpoint that restore would take;
  * integrity: the CRC32 of every leaf is checked on load;
  * async: ``AsyncCheckpointer.save`` copies the tree to host memory at
    once and writes it on a worker thread, so the train loop keeps
    stepping;
  * elastic: leaves are stored whole.  ``restore`` places them on
    ``device`` (the reference's ``shardings=``).  State whose shape
    depends on the data group's width (the data-parallel CNN step's int8
    residual) goes through ``fault_tolerance.elastic_reshard_cnn``, which
    folds it first;
  * durable: ``valid_steps`` lists the checkpoints that verify end to end,
    and ``restore_latest`` walks back from the newest step to the newest
    one that restores, so a corrupt or partial newest checkpoint degrades
    instead of stopping recovery.  ``.tmp-*`` directories are invisible to
    every reader.

Trees are nested dicts whose leaves are tensors, numpy arrays or Python
numbers.
"""
from __future__ import annotations

import json
import os
import pathlib
import re
import shutil
import threading
import zlib

import numpy as np
import torch

_SEP = "/"
BF16 = "bfloat16"


def _flatten(tree, prefix=()) -> dict:
    """{key: leaf}, keys the dict keys joined by "/" ("" for a bare
    leaf), in the order of sorted keys at every level (the reference's
    flatten order)."""
    if isinstance(tree, dict):
        out = {}
        for key in sorted(tree):
            out.update(_flatten(tree[key], prefix + (str(key),)))
        return out
    return {_SEP.join(prefix): tree}


def _unflatten(tree, flat: dict, prefix=()):
    if isinstance(tree, dict):
        return {key: _unflatten(v, flat, prefix + (str(key),))
                for key, v in tree.items()}
    return flat[_SEP.join(prefix)]


def to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A leaf as (a host copy to store, the dtype name for the manifest): a
    bf16 tensor as its uint16 bits under "bfloat16".  Always a copy, so a
    snapshot does not change when the training step later writes the
    leaf in place."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.uint16)
        arr = t.to("cpu", copy=True).numpy()
        if leaf.dtype == torch.bfloat16:
            return arr, BF16
    else:
        arr = np.array(leaf)
    if arr.dtype.name == BF16:            # a reference leaf (ml_dtypes)
        return arr.view(np.uint16), BF16
    return arr, str(arr.dtype)


def _dtype_ok(arr: np.ndarray, name: str) -> bool:
    if name == BF16:
        return arr.dtype.itemsize == 2 and arr.dtype.kind in "uV"
    return str(arr.dtype) == name


def _from_numpy(arr: np.ndarray, name: str, template, device):
    """The stored array as the leaf ``restore`` returns: a tensor (on
    ``device``, else where the template tensor lies) where the template is
    a tensor or a device is given, else the array; bf16 from its bits."""
    if not isinstance(template, torch.Tensor) and device is None:
        return arr
    if device is None:
        device = template.device
    arr = np.array(arr, order="C")       # a copy that keeps a 0-d shape
    if name == BF16:
        bits = torch.from_numpy(arr.view(np.uint16))
        return bits.view(torch.bfloat16).to(device, copy=True)
    return torch.from_numpy(arr).to(device, copy=True)


def save(ckpt_dir, step: int, tree, *, keep: int = 3) -> str:
    """Synchronous checkpoint write.  Returns the checkpoint's path."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    items = dict(tree) if isinstance(tree, _Snapshot) else \
        {key: to_numpy(leaf) for key, leaf in _flatten(tree).items()}
    tmp = ckpt_dir / f".tmp-step_{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": {}}
    for i, (key, (arr, name)) in enumerate(sorted(items.items())):
        fname = f"leaf_{i:05d}.npy"
        np.save(tmp / fname, arr)
        manifest["leaves"][key] = {
            "file": fname, "shape": list(arr.shape), "dtype": name,
            "crc32": zlib.crc32(arr.tobytes()),
        }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    final = ckpt_dir / f"step_{step}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(ckpt_dir, keep)
    return str(final)


class AsyncCheckpointer:
    """Copy to host memory at once, write on a worker thread."""

    def __init__(self, ckpt_dir, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree):
        snapshot = _Snapshot({key: to_numpy(leaf)
                              for key, leaf in _flatten(tree).items()})
        self.wait()

        def work():
            try:
                save(self.ckpt_dir, step, snapshot, keep=self.keep)
            except Exception as e:  # noqa: BLE001
                self.last_error = e
        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            # hand the error over once: a failed background save must not
            # poison every later save or wait with a stale exception
            err, self.last_error = self.last_error, None
            raise err


class _Snapshot(dict):
    """A flat {key: (host array, dtype name)} that ``AsyncCheckpointer``
    took; ``save`` writes it as it is."""


def all_steps(ckpt_dir) -> list[int]:
    """Every ``step_<N>`` directory under ``ckpt_dir``, ascending, with no
    claim of integrity (see ``valid_steps``).  ``.tmp-*`` directories are
    never listed."""
    ckpt_dir = pathlib.Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    return sorted(int(m.group(1)) for p in ckpt_dir.iterdir()
                  if (m := re.fullmatch(r"step_(\d+)", p.name)))


def latest_step(ckpt_dir) -> int | None:
    steps = all_steps(ckpt_dir)
    return steps[-1] if steps else None


def verify_checkpoint(ckpt_dir, step: int, *, deep: bool = True) -> bool:
    """True iff the checkpoint at ``step`` restores: the manifest parses,
    every leaf file exists and (``deep``) loads with its recorded shape,
    dtype and CRC32.  Never raises."""
    path = pathlib.Path(ckpt_dir) / f"step_{step}"
    try:
        manifest = json.loads((path / "manifest.json").read_text())
        for meta in manifest["leaves"].values():
            f = path / meta["file"]
            if not f.exists():
                return False
            if deep:
                arr = np.load(f)
                if (list(arr.shape) != list(meta["shape"])
                        or not _dtype_ok(arr, meta["dtype"])
                        or zlib.crc32(arr.tobytes()) != meta["crc32"]):
                    return False
        return True
    except Exception:  # noqa: BLE001 — any parse or I/O failure: not valid
        return False


def valid_steps(ckpt_dir, *, deep: bool = True) -> list[int]:
    """The steps whose checkpoints verify end to end, ascending: a torn
    write, flipped bytes or a mangled manifest disqualify a step without
    raising."""
    return [s for s in all_steps(ckpt_dir)
            if verify_checkpoint(ckpt_dir, s, deep=deep)]


def restore(ckpt_dir, step: int, target_tree, *, device=None,
            verify: bool = True, match_shapes: bool = False):
    """Restore into the structure of ``target_tree``.  Each leaf comes back
    with its stored shape and dtype: as a tensor on ``device``, or where
    the template's tensor lies when ``device`` is None, or as a numpy
    array where the template leaf is no tensor and no device is given.
    ``match_shapes``: refuse a checkpoint whose stored leaf shapes differ
    from the template's (walk-back uses it to skip checkpoints from before
    an elastic re-scale, whose residual has the old width)."""
    path = pathlib.Path(ckpt_dir) / f"step_{step}"
    manifest = json.loads((path / "manifest.json").read_text())
    flat_t = _flatten(target_tree)
    out = {}
    for key, tmpl in flat_t.items():
        meta = manifest["leaves"][key]
        shape = tuple(tmpl.shape) if hasattr(tmpl, "shape") else None
        if match_shapes and shape is not None \
                and list(meta["shape"]) != list(shape):
            raise ValueError(
                f"checkpoint leaf {key} has shape {meta['shape']} but the "
                f"template expects {list(shape)} (a checkpoint from before "
                f"an elastic re-scale?)")
        arr = np.load(path / meta["file"])
        if verify and zlib.crc32(arr.tobytes()) != meta["crc32"]:
            raise IOError(f"checkpoint corruption in leaf {key}")
        out[key] = _from_numpy(arr, meta["dtype"], tmpl, device)
    return _unflatten(target_tree, out)


def restore_latest(ckpt_dir, target_tree, *, device=None,
                   verify: bool = True, match_shapes: bool = True,
                   on_skip=None):
    """Walk-back restore: the newest checkpoint that restores (CRCs
    verified, every leaf present, shapes agreeing with the template).
    Returns ``(tree, step)``; ``(target_tree, 0)`` when nothing under
    ``ckpt_dir`` restores.  ``on_skip(step, exc)`` sees each checkpoint
    passed over."""
    for step in reversed(all_steps(ckpt_dir)):
        try:
            tree = restore(ckpt_dir, step, target_tree, device=device,
                           verify=verify, match_shapes=match_shapes)
            return tree, step
        except Exception as e:  # noqa: BLE001 — walk back past any bad step
            if on_skip is not None:
                on_skip(step, e)
    return target_tree, 0


def _gc(ckpt_dir, keep: int):
    ckpt_dir = pathlib.Path(ckpt_dir)
    steps = sorted([int(m.group(1)) for p in ckpt_dir.iterdir()
                    if (m := re.fullmatch(r"step_(\d+)", p.name))])
    for s in steps[:-keep]:
        shutil.rmtree(ckpt_dir / f"step_{s}", ignore_errors=True)
