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
``(params, opt_state)`` included.  The archive's members carry a fixed
timestamp, so the same tree always gives the same bytes.

:func:`restore_checkpoint` restores into the structure of a ``like_tree``
(the reference's argument), leaf by leaf checked for name, shape and
dtype; :class:`CheckpointManager` keeps the last ``keep_n`` steps and can
save on a background thread.

**Sharded trees.**  ``save_checkpoint(..., mesh=, specs=, cfg=)`` saves a
tree of which each rank holds its blocks under ``specs`` (the spec trees
of ``runtime.sharding``): each leaf is gathered into rank 0 of the world
(``shard.core.gather_leaf_to``), synchronously, and rank 0 writes the
unsharded format -- byte for byte the save of the gathered tree, which
the reference's ``restore_checkpoint`` reads.
``restore_checkpoint(..., mesh=, specs=, cfg=)`` is the counterpart of
the reference's ``shardings=``: each rank keeps its block of every leaf
for the target mesh (``shard.core.shard_leaf``), whatever mesh wrote it
-- elastic restore; the archive's stored members are memory-mapped, so a
rank reads only its blocks' pages.
"""

from __future__ import annotations

import json
import os
import shutil
import struct
import threading
import zipfile

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.runtime import collectives
from repro_torch.runtime.sharding import spec_leaves
from repro_torch.shard.core import gather_leaf_to, shard_leaf
from repro_torch.tree import leaf_paths
from repro_torch.tree import named_leaves as _named_leaves
from repro_torch.tree import rebuild as _rebuild
from repro_torch.tree import tree_map

# the members' zip timestamp (the earliest a zip can hold)
_ZIP_TIME = (1980, 1, 1, 0, 0, 0)


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_host(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    return _view_host(np.array(a), dtype)  # a writable, contiguous copy (0-d stays 0-d)


def _view_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    """``a`` as a tensor of the leaf's dtype, sharing its memory."""
    if dtype == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _step_dir(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step:08d}")


def _savez(path: str, arrays: dict) -> None:
    """``np.savez`` (stored members, zip64), with a fixed member time."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for name, a in arrays.items():
            with zf.open(zipfile.ZipInfo(name + ".npy", date_time=_ZIP_TIME), "w",
                         force_zip64=True) as f:
                np.lib.format.write_array(f, np.asanyarray(a), allow_pickle=False)


def _write(directory: str, step: int, names, leaves, metadata) -> str:
    """Write the host leaves atomically; returns the step's path."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = _step_dir(directory, step)
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    _savez(os.path.join(tmp, "arrays.npz"), {n: _to_host(t) for n, t in zip(names, leaves)})
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump({"step": step, "names": list(names),
                   "dtypes": [_dtype_name(t) for t in leaves],
                   "metadata": metadata or {}}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _gathered(tree, mesh, specs, cfg):
    """(names, full leaves on the host) of a sharded ``tree``, gathered one
    leaf at a time into rank 0 of the world; every rank of ``mesh`` takes
    part, and the others get ``None`` leaves."""
    names, leaves = [], []
    for (name, t), spec, path in zip(_named_leaves(tree), spec_leaves(specs, tree),
                                     leaf_paths(tree)):
        # gloo gathers on the host: take the block there once
        full = gather_leaf_to(t if mesh.backend == "nccl" else t.detach().cpu(), spec, mesh,
                              cfg, path)
        names.append(name)
        leaves.append(None if full is None else full.to("cpu", copy=True))
        del full
    return names, leaves


def _members(path: str) -> dict:
    """name -> a copy-on-write memory map of each member of an npz whose
    members are stored (``np.savez`` stores them), 0-d arrays aside: a
    leaf is read once, into its target, and a rank that keeps a block of a
    leaf reads only that block's pages."""
    out = {}
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for info in zf.infolist():
            if info.compress_type != zipfile.ZIP_STORED or not info.filename.endswith(".npy"):
                continue
            f.seek(info.header_offset)
            name_len, extra_len = struct.unpack("<HH", f.read(30)[26:30])
            f.seek(info.header_offset + 30 + name_len + extra_len)
            version = np.lib.format.read_magic(f)
            read = (np.lib.format.read_array_header_1_0 if version == (1, 0)
                    else np.lib.format.read_array_header_2_0)
            shape, fortran, dtype = read(f)
            if not shape or dtype.hasobject:
                continue
            out[info.filename[:-4]] = np.memmap(path, dtype=dtype, mode="c", offset=f.tell(),
                                                shape=shape, order="F" if fortran else "C")
    return out


def save_checkpoint(directory: str, step: int, tree, metadata: dict | None = None, *,
                    mesh=None, specs=None, cfg=None) -> str:
    """Atomic save of the tensor tree ``tree``; returns the step's path.

    ``mesh``: ``tree`` holds this rank's blocks under ``specs`` (``cfg``,
    the full model config, places the query heads); every rank of the
    mesh must call this, rank 0 of the world writes, and all return once
    the step is on disk."""
    if mesh is None:
        names, leaves = zip(*_named_leaves(tree))
        return _write(directory, step, names, leaves, metadata)
    names, leaves = _gathered(tree, mesh, specs, cfg)
    world = collectives.world(mesh)
    if world.rank == 0:
        _write(directory, step, names, leaves, metadata)
    collectives.barrier(world)
    return _step_dir(directory, step)


def restore_checkpoint(directory: str, step: int | None, like_tree, device=None, *,
                       mesh=None, specs=None, cfg=None):
    """Restore step ``step`` (None = the latest) into the structure of
    ``like_tree`` (a tensor tree, e.g. ``init_params(cfg, device="meta")``
    or ``(params, opt_state)``).  Every leaf's name must be ``like_tree``'s
    (else ``ValueError`` "structure mismatch"), and its shape and dtype
    those of the leaf it replaces (else ``ValueError`` "... needs ...").
    Leaves land on ``device``; by default on the device of the leaf they
    replace, and on the card for ``"meta"`` leaves (on a mesh, on the
    mesh's device).  Returns ``(step, tree, metadata)``.

    ``mesh``: each rank keeps its block of every leaf under ``specs`` (a
    spec tree like ``like_tree``, whose leaves have the full shapes;
    ``cfg``, the full model config, places the query heads) -- whatever
    mesh, or single process, saved the step."""
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
    if dev is None and mesh is not None:
        dev = mesh.device
    layout = ([(None, ())] * len(want) if mesh is None else
              list(zip(spec_leaves(specs, like_tree), leaf_paths(like_tree))))
    npz = os.path.join(path, "arrays.npz")
    mapped = _members(npz)
    leaves = []
    with np.load(npz) as data:
        for (name, ref), (spec, key) in zip(want, layout):
            if name in mapped:
                t = _view_host(mapped[name], dtypes[name])
            else:
                t = _from_host(data[name], dtypes[name])
            if t.shape != ref.shape or t.dtype != ref.dtype:
                raise ValueError(f"checkpoint leaf {name}: {tuple(t.shape)} {t.dtype}, "
                                 f"the tree needs {tuple(ref.shape)} {ref.dtype}")
            if mesh is not None:
                t = shard_leaf(t, spec, mesh, cfg, key)
            target = dev or (resolve_device(None) if ref.device.type == "meta"
                             else ref.device)
            # a mapped leaf held whole is still the file's pages: copy it
            leaves.append(t.to(target, copy=name in mapped))
    del mapped
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
    never reach a save in flight.

    ``mesh`` (with ``cfg``, the full model config): the trees are this
    rank's blocks, saved and restored as :func:`save_checkpoint` and
    :func:`restore_checkpoint` do under ``specs``.  Every rank calls
    ``save`` (the gather is synchronous; only rank 0's write moves to the
    thread), ``wait`` and ``restore_latest``: ``wait`` returns on every
    rank once the writer's step is on disk."""

    def __init__(self, directory: str, keep_n: int = 3, async_save: bool = False, *,
                 mesh=None, cfg=None):
        self.directory = directory
        self.keep_n = keep_n
        self.async_save = async_save
        self.mesh = mesh
        self.cfg = cfg
        self._thread: threading.Thread | None = None

    def save(self, step: int, tree, metadata=None, *, specs=None):
        if self.mesh is None:
            names, leaves = zip(*_named_leaves(
                tree_map(lambda t: t.detach().to("cpu", copy=True), tree)))
        else:
            names, leaves = _gathered(tree, self.mesh, specs, self.cfg)
            if collectives.world(self.mesh).rank != 0:
                return
        if self.async_save:
            self._join()
            self._thread = threading.Thread(
                target=self._save_and_gc, args=(step, names, leaves, metadata), daemon=True)
            self._thread.start()
        else:
            self._save_and_gc(step, names, leaves, metadata)

    def _save_and_gc(self, step, names, leaves, metadata):
        _write(self.directory, step, names, leaves, metadata)
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[:-self.keep_n]:
            shutil.rmtree(_step_dir(self.directory, s), ignore_errors=True)

    def restore_latest(self, like_tree, device=None, *, specs=None):
        self.wait()
        return restore_checkpoint(self.directory, None, like_tree, device, mesh=self.mesh,
                                  specs=specs, cfg=self.cfg)

    def _join(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def wait(self):
        """Until the last save is on disk (on a mesh, on every rank)."""
        self._join()
        if self.mesh is not None:
            collectives.barrier(collectives.world(self.mesh))
