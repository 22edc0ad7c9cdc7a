"""Fault-tolerant checkpointing in the reference's layout.

One directory per step:

    <dir>/step_000000123/
        manifest.json       # step, the data pipeline's state, shapes, dtypes
        arrays.npz          # the tree's arrays, keyed by their flat paths

* **atomic** — written to ``step_X.tmp`` and then ``os.replace``d, so a
  crash mid-save never corrupts the newest checkpoint;
* **async** — ``save(..., blocking=False)`` copies the tree to the host and
  hands the write to a thread, so the step loop is not stalled;
* **self-pruning** — keeps the newest ``keep`` checkpoints.

A tree is a nested dict, list or tuple of tensors (or numpy arrays, or
Python numbers); its flat paths are the reference's (``_flatten``: dict
keys sorted, list and tuple positions by index, joined by ``/``), so an
fp32 checkpoint written by either package restores into the other.  A
bfloat16 tensor is stored as its uint16 bits with ``"bfloat16"`` in the
manifest (numpy has no bfloat16 without ``ml_dtypes``); the reference
cannot read those arrays back as bfloat16.
"""
from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from ..models.common import unported

__all__ = ["CheckpointManager"]


def _flatten(tree, prefix: str = "") -> dict:
    out = {}
    if isinstance(tree, dict):
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif tree is not None:
        out[prefix[:-1]] = tree
    return out


def _unflatten_into(template, flat: dict):
    def below(key):
        key = str(key)
        return {p[len(key) + 1:]: a for p, a in flat.items() if p.split("/")[0] == key}

    if isinstance(template, dict):
        return {k: _unflatten_into(v, below(k)) for k, v in template.items()}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten_into(v, below(i)) for i, v in enumerate(template))
    if template is None:
        return None
    return flat[""]


def _to_host(x) -> tuple[np.ndarray, str]:
    """(numpy array, manifest dtype) of a leaf; bfloat16 as its uint16 bits."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.cpu().view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        return x.cpu().numpy().copy(), str(x.cpu().numpy().dtype)
    a = np.array(x)  # a copy
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str, like):
    """A stored array as a tensor (on the template leaf's device, if it is a
    tensor); bfloat16 from its 16 bits, whichever 2-byte type holds them."""
    a = np.array(a, order="C")  # keeps a 0-d array 0-d
    if dtype == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(like.device) if isinstance(like, torch.Tensor) else t


class CheckpointManager:
    def __init__(self, directory: str, *, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._writer: threading.Thread | None = None

    # ------------------------------------------------------------------ save
    def save(self, step: int, tree, *, extra: dict | None = None, blocking: bool = True):
        """``tree``: a tree of tensors (the trainer's parameters and
        optimizer state); ``extra``: JSON-serialisable metadata (the data
        pipeline's cursor).  The host copy is taken before this returns,
        so the tree may change while an asynchronous write runs."""
        self.wait()  # one writer at a time
        host, dtypes = {}, {}
        for k, v in _flatten(tree).items():
            host[k], dtypes[k] = _to_host(v)

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            np.savez(os.path.join(tmp, "arrays.npz"), **host)
            manifest = {
                "step": step,
                "extra": extra or {},
                "arrays": {k: {"shape": list(v.shape), "dtype": dtypes[k]} for k, v in host.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._prune()

        if blocking:
            write()
        else:
            self._writer = threading.Thread(target=write, daemon=True)
            self._writer.start()

    def wait(self):
        if self._writer is not None:
            self._writer.join()
            self._writer = None

    def _prune(self):
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name.split("_")[1]))
                except ValueError:
                    continue
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, *, step: int | None = None, shardings=None):
        """``(tree, extra, step)``: checkpoint ``step`` (the newest by
        default) in the structure of ``template``, each leaf a tensor on
        the device of the template's leaf where that is a tensor (else on
        the CPU), in the stored dtype."""
        if shardings is not None:
            raise unported("restoring onto shardings (a device mesh)", "A7")
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        like = _flatten(template)
        with np.load(os.path.join(path, "arrays.npz")) as data:
            flat = {k: _from_host(data[k], manifest["arrays"][k]["dtype"], like.get(k))
                    for k in data.files}
        return _unflatten_into(template, flat), manifest["extra"], step
