"""Checkpointing: atomic, content-hashed, retention-managed, resumable
(the reference's ``repro.checkpoint.manager``, with the same layout and
guarantees).

Layout (one directory per step)::

    <dir>/step_00000042/
        index.json.zlib      # leaf paths, shapes, dtypes, hashes
        arr_00000_p00.npy    # one file per leaf, in the tree's fixed order
        ...
    <dir>/LATEST             # atomically-updated pointer

The tree is the port's own (``repro_torch.tree``: dicts, lists, tensors),
its leaves walked in a fixed order; bfloat16 leaves are stored through a
``uint16`` view.  The index is JSON compressed with the standard library's
``zlib`` (the reference writes msgpack + zstandard; this package needs
neither, and does not read the reference's checkpoints: move weights
between the packages with ``repro_torch.convert``).

Fault model: a writer can die mid-checkpoint -- it writes ``step_X.tmpN``
then renames it (atomic on POSIX) -- and ``restore_latest`` checks the
blake2b hash of every leaf, falling back to older steps on corruption.
SIGTERM-triggered saves are wired in the train CLI
(``distributed.fault.PreemptionGuard``).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import zlib

import numpy as np
import torch

from repro_torch.tree import leaves, paths, unflatten

INDEX = "index.json.zlib"


def _leaf_hash(arr: np.ndarray) -> str:
    return hashlib.blake2b(arr.tobytes(), digest_size=16).hexdigest()


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """A tensor leaf as the array written to disk, and its dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        raise TypeError(f"checkpoint leaves are tensors, got {type(leaf)}")
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:       # numpy has no bf16 of its own
        return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if str(arr.dtype) != dtype:
        raise ValueError(f"leaf stored as {arr.dtype}, index says {dtype}")
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, process_index: int = 0):
        self.dir = directory
        self.keep = keep
        self.process_index = process_index
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save ----
    def save(self, step: int, tree, extra: dict | None = None) -> str:
        flat = leaves(tree)
        name = f"step_{step:08d}"
        final = os.path.join(self.dir, name)
        tmp = final + f".tmp{self.process_index}"
        os.makedirs(tmp, exist_ok=True)
        index = {"paths": paths(tree), "n": len(flat), "step": step,
                 "extra": extra or {}, "leaves": []}
        for i, leaf in enumerate(flat):
            arr, dtype = _to_numpy(leaf)
            fn = f"arr_{i:05d}_p{self.process_index:02d}.npy"
            np.save(os.path.join(tmp, fn), arr)
            index["leaves"].append({
                "file": fn, "shape": list(arr.shape), "dtype": dtype,
                "hash": _leaf_hash(arr)})
        blob = zlib.compress(json.dumps(index).encode())
        with open(os.path.join(tmp, INDEX), "wb") as f:
            f.write(blob)
        os.replace(tmp, final)  # atomic publish
        self._write_latest(name)
        self._retain()
        return final

    def _write_latest(self, name: str):
        tmp = os.path.join(self.dir, f".LATEST.tmp{self.process_index}")
        with open(tmp, "w") as f:
            f.write(name)
        os.replace(tmp, os.path.join(self.dir, "LATEST"))

    def _retain(self):
        steps = sorted(self.all_steps())
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ---------------------------------------------------------- restore ----
    def all_steps(self):
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(
                    tuple(f".tmp{i}" for i in range(100))):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def _load(self, step: int, like):
        path = os.path.join(self.dir, f"step_{step:08d}")
        with open(os.path.join(path, INDEX), "rb") as f:
            try:
                index = json.loads(zlib.decompress(f.read()))
            except zlib.error as e:
                raise ValueError(f"unreadable index: {e}") from e
        if index["paths"] != paths(like):
            raise ValueError(f"step {step} holds another tree than the one "
                             "to restore into")
        out = []
        for meta, ref in zip(index["leaves"], leaves(like)):
            arr = np.load(os.path.join(path, meta["file"]))
            if _leaf_hash(arr) != meta["hash"]:
                raise IOError(f"corrupt leaf {meta['file']} at step {step}")
            t = _from_numpy(arr, meta["dtype"])
            if tuple(t.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {meta['file']} has shape "
                                 f"{tuple(t.shape)}, the tree wants "
                                 f"{tuple(ref.shape)}")
            out.append(t.to(ref.device))
        return unflatten(like, out), index["step"], index["extra"]

    def restore(self, step: int, like):
        """``(tree, step, extra)`` of ``step``, the tree built like
        ``like`` and each leaf on its leaf's device."""
        return self._load(step, like)

    def restore_latest(self, like):
        """Newest → oldest with corruption fallback.  Returns
        (tree, step, extra) or (None, -1, {})."""
        for step in reversed(self.all_steps()):
            try:
                return self._load(step, like)
            except (IOError, OSError, ValueError) as e:
                print(f"[checkpoint] step {step} unreadable ({e}); "
                      f"falling back")
        return None, -1, {}
