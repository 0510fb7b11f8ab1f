"""Carry the reference's parameters across into the port.

``params_from_jax(np_tree, cfg, device)`` takes the tree that
``jax.tree_util.tree_map(np.asarray, repro.models.model.init_params(cfg,
key))`` gives — numpy arrays, bf16 ones with the ``ml_dtypes`` bfloat16
dtype — and returns the port's parameter tree, same layout:
``"head_blocks"`` holds a MoE stack's leading dense layers, ``"blocks"``
is a tuple with one slot tree per ``block_pattern`` entry, each leaf
stacked over periods; weights bf16 ``(d_in, d_out)`` (expert stacks
``(E, d_in, d_out)``), norm scales and the MoE router f32.  An
encoder-decoder's tree also carries ``enc_blocks`` (stacked over its
``n_encoder_layers``), ``enc_tail_blocks``, ``enc_final_norm`` and
``cross_blocks`` (``xattn`` and ``norm_x``, stacked over periods).
Leaves that are already tensors (``checkpoint.restore_checkpoint``) are
moved as they are.  ``opt_state_from_jax`` carries the reference's AdamW
state across the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models.transformer import layer_layout


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


# an encoder-decoder's leaves beside the decoder's
ENC_KEYS = ("enc_blocks", "enc_tail_blocks", "enc_final_norm", "cross_blocks")


def params_from_jax(np_tree, cfg: ModelConfig, device=None):
    """The reference's numpy parameter tree -> the port's, on ``device``."""
    dev = resolve_device(device)
    lead, n_periods, tail = layer_layout(cfg)
    if tuple(np.shape(np_tree["embed"])) != (cfg.vocab_size, cfg.d_model):
        raise ValueError(f"embed {np.shape(np_tree['embed'])} does not match "
                         f"cfg ({cfg.vocab_size}, {cfg.d_model})")
    if len(np_tree.get("blocks", ())) != (len(cfg.block_pattern) if n_periods else 0):
        raise ValueError("the tree's block slots do not match cfg.block_pattern")
    if (len(np_tree.get("tail_blocks", [])) != len(tail)
            or len(np_tree.get("head_blocks", [])) != lead):
        raise ValueError(f"the tree's layer layout does not match cfg ({lead} lead "
                         f"layers, {n_periods} periods, {len(tail)} tail layers)")
    keep = ("embed", "head_blocks", "blocks", "tail_blocks", "final_norm", "head")
    if cfg.is_encoder_decoder:
        missing = [k for k in ENC_KEYS if k not in np_tree]
        if missing:
            raise ValueError(f"an encoder-decoder tree needs {missing}")
        keep += ENC_KEYS
    out = {k: _convert(np_tree[k], dev) for k in keep if k in np_tree}
    out.setdefault("head_blocks", [])
    stacks = [(slot["norm1"], n_periods, "blocks") for slot in out.get("blocks", ())]
    if cfg.is_encoder_decoder:
        _, n_enc, _ = layer_layout(cfg, cfg.n_encoder_layers)
        stacks += [(slot["norm1"], n_enc, "enc_blocks") for slot in out["enc_blocks"]]
        if n_periods:
            stacks.append((out["cross_blocks"]["norm_x"], n_periods, "cross_blocks"))
    for lead_axis, want, name in stacks:
        if lead_axis.shape[0] != want:
            raise ValueError(f"{name} are stacked over {lead_axis.shape[0]} "
                             f"periods, cfg has {want}")
    return out


def opt_state_from_jax(np_state, cfg: ModelConfig, device=None):
    """The reference's AdamW state (``adamw_init`` / ``adamw_update``'s
    ``{"step", "m", "v", "master"}``, as numpy) -> the port's, on
    ``device``: each of ``m``, ``v`` and ``master`` carried across as
    :func:`params_from_jax` carries the weights (f32 leaves stay f32),
    ``step`` a 0-d int32 tensor."""
    dev = resolve_device(device)
    out = {k: params_from_jax(np_state[k], cfg, dev) for k in ("m", "v", "master")}
    out["step"] = torch.tensor(int(np.asarray(np_state["step"])), dtype=torch.int32, device=dev)
    return out
