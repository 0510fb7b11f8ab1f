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
Either package reads what the other writes.

The reference's ``CheckpointManager`` and asynchronous saves belong to
training (ROADMAP queue 1, item 9), resharding on restore to distribution
(item 10).
"""

from __future__ import annotations

import json
import os
import shutil

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import init_params
from repro_torch.models.weights import params_from_jax


def _named_leaves(tree, path: str = ""):
    """(keystr path, leaf) pairs in ``jax.tree_util`` order: dict keys
    sorted, lists and tuples in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _named_leaves(tree[k], f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, f"{path}[{i}]")
    else:
        yield path, tree


def _rebuild(like, leaves):
    """``like``'s structure with its leaves taken from the ``leaves``
    iterator, in ``_named_leaves`` order."""
    if isinstance(like, dict):
        return {k: _rebuild(like[k], leaves) for k in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves) for v in like)
    return next(leaves)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def save_checkpoint(directory: str, step: int, params, metadata: dict | None = None) -> str:
    """Atomic save of the tensor tree ``params``; returns the step's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = _step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    names, leaves = zip(*_named_leaves(params))
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


def restore_checkpoint(directory: str, step: int | None, cfg: ModelConfig, device=None):
    """Load step ``step`` (None = the latest) as the port's parameter tree
    for ``cfg`` on ``device`` (default CUDA).  Every leaf's name, shape and
    dtype must be the layout ``cfg`` implies; anything else raises
    ``ValueError``.  Returns ``(step, params, metadata)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = _step_dir(directory, step)
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    like = init_params(cfg, device="meta")
    want = list(_named_leaves(like))
    if [n for n, _ in want] != meta["names"]:
        missing = sorted({n for n, _ in want} - set(meta["names"]))
        extra = sorted(set(meta["names"]) - {n for n, _ in want})
        raise ValueError(f"checkpoint structure mismatch for {cfg.name}: missing "
                         f"{missing[:4]}, unexpected {extra[:4]}")
    dtypes = dict(zip(meta["names"], meta["dtypes"]))
    leaves = []
    with np.load(os.path.join(path, "arrays.npz")) as data:
        for name, ref in want:
            t = _from_host(data[name], dtypes[name])
            if t.shape != ref.shape or t.dtype != ref.dtype:
                raise ValueError(f"checkpoint leaf {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"{cfg.name} needs {tuple(ref.shape)} {ref.dtype}")
            leaves.append(t)
    params = params_from_jax(_rebuild(like, iter(leaves)), cfg, device)
    return meta["step"], params, meta["metadata"]


def latest_step(directory: str) -> int | None:
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None
