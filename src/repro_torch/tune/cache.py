"""Persistent per-shape blocking cache (paper §II-D: remember the right
blocking for the layer at hand), the port's counterpart of
``repro/tune/cache.py``.

Entries are keyed by everything that changes the winner:

  kind | shape | dtype bytes | stride/padding | backend | device kind

where backend is the device type the blocking runs on ("cuda" or "cpu")
and device kind the card's name (``torch.cuda.get_device_name``), so a
blocking timed on one card never serves another.  The key format, the file
format and ``CACHE_VERSION`` are the reference's, so one file may hold both
packages' entries (their backends differ) without either load discarding
the other's.  The default file is the port's own,
``~/.cache/repro_torch_tune/blockings-v4.json``; ``REPRO_TUNE_CACHE``
overrides it.  Writes are atomic (temporary file + ``os.replace``) and
merge what other processes saved meanwhile.  A version mismatch or a torn
file reads as an empty cache.
"""
from __future__ import annotations

import json
import os
import sys
import tempfile
import threading
import time

CACHE_VERSION = 4
_ENV_VAR = "REPRO_TUNE_CACHE"


def default_cache_path() -> str:
    env = os.environ.get(_ENV_VAR)
    if env:
        return env
    base = os.environ.get("XDG_CACHE_HOME",
                          os.path.join(os.path.expanduser("~"), ".cache"))
    return os.path.join(base, "repro_torch_tune",
                        f"blockings-v{CACHE_VERSION}.json")


def device_kind() -> str:
    """Cache-key component: the card the blocking was tuned on ("cpu"
    without one)."""
    import torch
    if not torch.cuda.is_available():
        return "cpu"
    return torch.cuda.get_device_name(0).replace("|", "_")


def conv_key(*, kind: str, h: int, w: int, c: int, k: int, r: int, s: int,
             stride: int, padding: int, dtype_bytes: int, backend: str,
             minibatch: int = 1, device: str | None = None) -> str:
    device = device or device_kind()
    return (f"conv|{kind}|n{minibatch}h{h}w{w}c{c}k{k}r{r}s{s}"
            f"|st{stride}pd{padding}|b{dtype_bytes}|{backend}|{device}")


class TuneCache:
    """In-memory dict over a versioned JSON file.  Thread-safe; loaded on
    first use."""

    def __init__(self, path: str | None = None):
        self.path = path or default_cache_path()
        self._entries: dict[str, dict] | None = None
        self._lock = threading.Lock()
        self._warned_readonly = False

    def _read_file(self) -> dict[str, dict]:
        try:
            with open(self.path, encoding="utf-8") as f:
                blob = json.load(f)
            if blob.get("version") == CACHE_VERSION:
                return dict(blob.get("entries", {}))
        except (OSError, ValueError, AttributeError):
            pass                      # cold cache / torn file / not a dict
        return {}

    def _load_locked(self) -> dict[str, dict]:
        if self._entries is None:
            self._entries = self._read_file()
        return self._entries

    def save(self) -> None:
        """Write every entry atomically, merged over what the file holds
        now (this process's entries win on a conflict)."""
        with self._lock:
            merged = self._read_file()
            merged.update(self._load_locked())
            self._entries = merged
            blob = {"version": CACHE_VERSION, "entries": merged}
            d = os.path.dirname(self.path) or "."
            os.makedirs(d, exist_ok=True)
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "w", encoding="utf-8") as f:
                    json.dump(blob, f, indent=1, sort_keys=True)
                os.replace(tmp, self.path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise

    def lookup(self, key: str) -> dict | None:
        with self._lock:
            e = self._load_locked().get(key)
        return dict(e) if e is not None else None

    def store(self, key: str, blocking: dict, *, source: str,
              score_us: float, budget: int | None = None,
              persist: bool = True) -> None:
        """Record a winner.  ``budget`` is the working-set budget it was
        chosen under (``lookup_conv`` checks it)."""
        entry = {"blocking": dict(blocking), "source": source,
                 "score_us": float(score_us), "version": CACHE_VERSION,
                 "tuned_at": time.time()}
        if budget is not None:
            entry["budget"] = int(budget)
        with self._lock:
            self._load_locked()[key] = entry
        if persist:
            try:
                self.save()
            except OSError as e:     # unwritable path: keep tuning in-memory
                if not self._warned_readonly:
                    self._warned_readonly = True
                    print(f"repro_torch.tune: cache not persisted "
                          f"({self.path}: {e}); continuing in-memory",
                          file=sys.stderr)

    def __len__(self) -> int:
        with self._lock:
            return len(self._load_locked())


_default: TuneCache | None = None
_default_lock = threading.Lock()


def default_cache() -> TuneCache:
    """Process-wide cache (made anew when ``REPRO_TUNE_CACHE`` moved)."""
    global _default
    with _default_lock:
        if _default is None or _default.path != default_cache_path():
            _default = TuneCache()
        return _default
