"""Measured autotune cache: persisted backend timings keyed by problem shape
and device.

When the cache holds timings for a problem close enough in size to the one
being dispatched, on the same device, the fastest measured capable backend
wins; otherwise selection falls back to the static priorities.

The cache is one JSON file:

* ``$REPRO_TORCH_SOLVERS_CACHE`` when set,
* ``~/.cache/repro_torch_solvers.json`` otherwise.

Nearest-size matching: a measurement only transfers to problems within
``NEAREST_MAX_RATIO`` (4x) in both ``n`` and effective band width.
"""
from __future__ import annotations

import json
import math
import os
import tempfile
import warnings

from .problem import Problem

__all__ = [
    "AutotuneCache",
    "ENV_VAR",
    "NEAREST_MAX_RATIO",
    "cache_path",
    "get_cache",
    "invalidate",
]

ENV_VAR = "REPRO_TORCH_SOLVERS_CACHE"
DEFAULT_USER_PATH = os.path.join("~", ".cache", "repro_torch_solvers.json")
NEAREST_MAX_RATIO = 4.0
_VERSION = 1

# Fields that identify a measurement row.  ``tolerance`` keeps approximate
# tiers from steering exact dispatches, ``devices`` keeps single-device and
# multi-device candidate sets apart, and ``device`` (the device's name)
# keeps a CPU measurement from steering a dispatch on the card, or one card
# model from steering another.
_KEY_FIELDS = ("op", "structure", "dtype", "bw", "n", "tolerance", "devices", "device")
_EXACT_FIELDS = ("op", "structure", "dtype", "tolerance", "devices", "device")


def cache_path() -> str:
    return os.path.expanduser(os.environ.get(ENV_VAR) or DEFAULT_USER_PATH)


def _entry_key(e: dict) -> tuple:
    return tuple(e[f] for f in _KEY_FIELDS)


def _problem_key(p: Problem) -> tuple:
    return (p.op, p.structure, p.dtype, p.bw, p.n, float(p.tolerance), int(p.devices), p.device)


class AutotuneCache:
    """In-memory view of the persisted measurement file."""

    def __init__(self, path: str | None = None, entries: list[dict] | None = None):
        self.path = path
        self.entries: list[dict] = entries or []

    @classmethod
    def load(cls, path: str) -> "AutotuneCache":
        entries: list[dict] = []
        try:
            with open(path) as f:
                raw = json.load(f)
            for e in raw.get("entries", []):
                e.setdefault("tolerance", 0.0)  # rows without a tolerance are exact rows
                e.setdefault("devices", 1)  # rows without a device count are local rows
                if all(f in e for f in _KEY_FIELDS) and isinstance(e.get("times_us"), dict):
                    entries.append(e)
        except FileNotFoundError:
            pass  # no cache yet == empty cache
        except (OSError, ValueError, AttributeError, TypeError, KeyError) as err:
            # a silently-vanished cache looks like a perf regression: warn,
            # then let the static priorities take over
            warnings.warn(
                f"autotune cache {path!r} is unreadable "
                f"({type(err).__name__}: {err}); starting with an empty cache",
                RuntimeWarning,
                stacklevel=2,
            )
            entries = []
        return cls(path=path, entries=entries)

    def save(self, path: str | None = None) -> str:
        path = path or self.path or cache_path()
        folder = os.path.dirname(os.path.abspath(path))
        os.makedirs(folder, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=folder, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump({"version": _VERSION, "entries": self.entries}, f, indent=2, sort_keys=True)
                f.write("\n")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self.path = path
        return path

    def record(self, problem: Problem, times_us: dict[str, float]) -> dict:
        """Merge backend timings for ``problem``'s key (latest wins)."""
        key = _problem_key(problem)
        times = {k: round(float(v), 2) for k, v in times_us.items()}
        for e in self.entries:
            if _entry_key(e) == key:
                e["times_us"].update(times)
                return e
        entry = dict(zip(_KEY_FIELDS, key))
        entry["times_us"] = times
        self.entries.append(entry)
        return entry

    def record_widths(self, problem: Problem, width_us: dict[int, float]) -> dict:
        """Merge stacked-RHS coalescing-width timings (width → measured µs
        per dispatch at that width) into ``problem``'s entry; read by
        :meth:`best_width`, the solve service's coalescing cap."""
        entry = self.lookup(problem)
        if entry is None:
            entry = dict(zip(_KEY_FIELDS, _problem_key(problem)))
            entry["times_us"] = {}
            self.entries.append(entry)
        entry.setdefault("width_us", {}).update(
            {str(int(w)): round(float(v), 2) for w, v in width_us.items()})
        return entry

    def record_page_sizes(self, problem: Problem, page_us: dict[int, float]) -> dict:
        """Merge KV-cache page-size timings (page size → measured paged-serve
        µs at that size) into ``problem``'s entry (op="decode",
        structure="paged_kv", n=max_len); read by :meth:`best_page_size`,
        the serving engine's default page size."""
        entry = self.lookup(problem)
        if entry is None:
            entry = dict(zip(_KEY_FIELDS, _problem_key(problem)))
            entry["times_us"] = {}
            self.entries.append(entry)
        entry.setdefault("page_us", {}).update(
            {str(int(p)): round(float(v), 2) for p, v in page_us.items()})
        return entry

    def lookup(self, problem: Problem) -> dict | None:
        key = _problem_key(problem)
        return next((e for e in self.entries if _entry_key(e) == key), None)

    def _matches(self, problem: Problem) -> list[tuple[float, dict]]:
        want = tuple(getattr(problem, f) for f in _EXACT_FIELDS)
        out = []
        for e in self.entries:
            # exact on every non-size key: size transfer interpolates over
            # speed, never over accuracy tier, device count or device
            if tuple(e[f] for f in _EXACT_FIELDS) != want:
                continue
            n_ratio = max(e["n"], problem.n) / max(min(e["n"], problem.n), 1)
            bwa, bwb = e["bw"] + 1, problem.bw + 1
            bw_ratio = max(bwa, bwb) / min(bwa, bwb)
            if n_ratio > NEAREST_MAX_RATIO or bw_ratio > NEAREST_MAX_RATIO:
                continue
            out.append((math.log(n_ratio) + math.log(bw_ratio), e))
        out.sort(key=lambda t: t[0])
        return out

    def best(self, problem: Problem, candidates: list[str]) -> str | None:
        """Fastest measured backend among ``candidates`` for the nearest
        matching measurement, or None when nothing transferable exists."""
        for _, e in self._matches(problem):
            times = {k: v for k, v in e["times_us"].items() if k in candidates}
            if times:
                return min(times, key=times.get)
        return None

    def best_width(self, problem: Problem) -> int | None:
        """Measured most µs-per-column-efficient coalescing width for the
        nearest matching stacked-RHS sweep, or None when nothing
        transferable was measured (callers then coalesce fully)."""
        for _, e in self._matches(problem):
            wu = e.get("width_us")
            if wu:
                return int(min(wu, key=lambda w: wu[w] / int(w)))
        return None

    def best_page_size(self, problem: Problem) -> int | None:
        """Measured fastest KV page size for the nearest matching paged-serve
        sweep, or None when nothing transferable was measured (the engine
        then takes its default, 16)."""
        for _, e in self._matches(problem):
            pu = e.get("page_us")
            if pu:
                return int(min(pu, key=pu.get))
        return None


# module-level cache with mtime-based reload (a tuning run may write the
# file mid-process; dispatch must see fresh data)
_loaded: tuple[str, float, AutotuneCache] | None = None


def _mtime(path: str) -> float:
    try:
        return os.stat(path).st_mtime
    except OSError:
        return -1.0


def get_cache() -> AutotuneCache:
    global _loaded
    path = cache_path()
    mt = _mtime(path)
    if _loaded is not None and _loaded[0] == path and _loaded[1] == mt:
        return _loaded[2]
    cache = AutotuneCache.load(path)
    _loaded = (path, mt, cache)
    return cache


def invalidate() -> None:
    """Drop the module-level cache (after swapping ``$REPRO_TORCH_SOLVERS_CACHE``)."""
    global _loaded
    _loaded = None
