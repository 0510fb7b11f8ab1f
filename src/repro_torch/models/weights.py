"""Carry the reference's parameters across into the port.

``params_from_jax(np_tree, cfg, device)`` takes the tree that
``jax.tree_util.tree_map(np.asarray, repro.models.model.init_params(cfg,
key))`` gives — numpy arrays, bf16 ones with the ``ml_dtypes`` bfloat16
dtype — and returns the port's parameter tree, same layout: ``"blocks"``
is a tuple with one slot tree per ``block_pattern`` entry, each leaf
stacked over periods; weights bf16 ``(d_in, d_out)``, norm scales f32.
Leaves that are already tensors (``checkpoint.restore_checkpoint``) are
moved as they are.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import layer_layout


def _to_torch(a, device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable copy: the tree's arrays may be read-only
    if a.dtype.name == "bfloat16":
        # torch.from_numpy refuses ml_dtypes' bfloat16: move the bits
        t = torch.from_numpy(a.view(np.uint16).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _convert(tree, device):
    if isinstance(tree, dict):
        return {k: _convert(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_convert(v, device) for v in tree]
    if isinstance(tree, tuple):
        return tuple(_convert(v, device) for v in tree)
    return _to_torch(tree, device)


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    """The reference's numpy parameter tree -> the port's, on ``device``."""
    dev = resolve_device(device)
    n_periods, tail = layer_layout(cfg)
    if tuple(np.shape(np_tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {np.shape(np_tree['embed'])} does not match "
                         f"cfg ({cfg.vocab_size}, {cfg.d_model})")
    if len(np_tree.get("blocks", ())) != (len(cfg.block_pattern) if n_periods else 0):
        raise ValueError("the tree's block slots do not match cfg.block_pattern")
    if len(np_tree.get("tail_blocks", [])) != len(tail) or np_tree.get("head_blocks"):
        raise ValueError("the tree's layer layout does not match cfg")
    keep = ("embed", "blocks", "tail_blocks", "final_norm", "head")
    out = {k: _convert(np_tree[k], dev) for k in keep if k in np_tree}
    out["head_blocks"] = []
    for slot in out.get("blocks", ()):
        if slot["norm1"].shape[0] != n_periods:
            raise ValueError(f"blocks are stacked over {slot['norm1'].shape[0]} "
                             f"periods, cfg has {n_periods}")
    return out
