"""Model checkpoints in the reference's format (port of
``repro/checkpoint/checkpoint.py``).

One directory per step, ``<dir>/step_<8 digits>/``, holding

* ``arrays.npz`` -- every leaf as a full host array, keyed by its
  ``jax.tree_util.keystr`` path (``"['blocks'][0]['attn']['wq']"``), dict
  keys in sorted order as ``jax.tree_util`` flattens them;
* ``meta.json`` -- ``step``, the leaf ``names`` in that order, their true
  ``dtypes`` and the user ``metadata``.

npz has no bfloat16, so bf16 leaves are stored as ``uint16`` bit views
with ``"bfloat16"`` recorded in ``dtypes`` (the port moves the bits
through ``int16`` into ``torch.bfloat16``; it needs no ``ml_dtypes``).
A save is written to ``<dir>/tmp.<step>.<pid>`` and renamed into place
with ``os.replace``, so a crash never leaves a partial step directory.
Either package reads what the other writes, a training state
``(params, opt_state)`` included.

:func:`restore_checkpoint` restores into the structure of a ``like_tree``
(the reference's argument), leaf by leaf checked for name, shape and
dtype; :class:`CheckpointManager` keeps the last ``keep_n`` steps and can
save on a background thread.  Sharded checkpoints and resharding on
restore (elastic restore) are not ported yet (ROADMAP queue 1, item 10.2):
a sharded run restores the whole tree and slices it (``shard.shard_params``).
"""

from __future__ import annotations

import json
import os
import shutil
import threading

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.tree import named_leaves as _named_leaves
from repro_torch.tree import rebuild as _rebuild
from repro_torch.tree import tree_map


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy (0-d stays 0-d)
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, tree, metadata: dict | None = None) -> str:
    """Atomic save of the tensor tree ``tree``; returns the step's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = _step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, leaves = zip(*_named_leaves(tree))
    np.savez(os.path.join(tmp, "arrays.npz"),
             **{n: _to_host(t) for n, t in zip(names, leaves)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "names": list(names),
                   "dtypes": [_dtype_name(t) for t in leaves],
                   "metadata": metadata or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def restore_checkpoint(directory: str, step: int | None, like_tree, device=None):
    """Restore step ``step`` (None = the latest) into the structure of
    ``like_tree`` (a tensor tree, e.g. ``init_params(cfg, device="meta")``
    or ``(params, opt_state)``).  Every leaf's name must be ``like_tree``'s
    (else ``ValueError`` "structure mismatch"), and its shape and dtype
    those of the leaf it replaces (else ``ValueError`` "... needs ...").
    Leaves land on ``device``; by default on the device of the leaf they
    replace, and on the card for ``"meta"`` leaves.  Returns ``(step,
    tree, metadata)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    want = list(_named_leaves(like_tree))
    if [n for n, _ in want] != meta["names"]:
        missing = sorted({n for n, _ in want} - set(meta["names"]))
        extra = sorted(set(meta["names"]) - {n for n, _ in want})
        raise ValueError(f"checkpoint structure mismatch: missing {missing[:4]}, "
                         f"unexpected {extra[:4]}")
    dtypes = dict(zip(meta["names"], meta["dtypes"]))
    dev = None if device is None else resolve_device(device)
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, ref in want:
            t = _from_host(data[name], dtypes[name])
            if t.shape != ref.shape or t.dtype != ref.dtype:
                raise ValueError(f"checkpoint leaf {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"the tree needs {tuple(ref.shape)} {ref.dtype}")
            target = dev or (resolve_device(None) if ref.device.type == "meta"
                             else ref.device)
            leaves.append(t.to(target))
    return meta["step"], _rebuild(like_tree, iter(leaves)), meta["metadata"]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


class CheckpointManager:
    """Keeps the last ``keep_n`` checkpoints; optional async (background
    thread) saves -- the training loop only pays for the host copy, taken
    before the thread starts, so later in-place updates of the tensors
    never reach a save in flight."""

    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = False):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, metadata=None):
        host_tree = tree_map(lambda t: t.detach().to("cpu", copy=True), tree)
        if self.async_save:
            self.wait()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, host_tree, metadata), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, host_tree, metadata)

    def _save_and_gc(self, step, host_tree, metadata):
        save_checkpoint(self.directory, step, host_tree, metadata)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def restore_latest(self, like_tree, device=None):
        self.wait()
        return restore_checkpoint(self.directory, None, like_tree, device)

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()
