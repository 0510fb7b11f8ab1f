"""Batched k-token verification: one dispatch, greedy accept.

Port of ``repro/spec/verify.py``.  The verify window for a lane at
position ``pos`` (cache rows < pos written, last sampled token t0 not yet
appended) is ``[t0, d1 .. dk]`` -- W = k + 1 rows at absolute positions
``pos .. pos + k``.  One :func:`repro_torch.models.model.verify_step` writes
all W K/V rows and returns (B, W, V) logits; row c's argmax is the token
plain greedy decode would emit after accepting rows <= c.

Accept rule:

    targets   = argmax(logits, -1)                       # (B, W)
    match[c]  = draft[c] == targets[c]                   # d_{c+1} vs row c
    ok[c]     = match[c] and c < n_draft                 # mask the pad
    accepted  = length of the leading all-ok run (cumprod-sum)
    new_pos   = pos + accepted + 1                       # +1: bonus row

The emitted tokens are ``targets[:accepted + 1]``: the accepted drafts are
by construction the argmax chain plain decode produces, and row
``accepted`` is either the correction (first mismatch) or the bonus token
(full accept), so greedy speculative output equals plain decode.  Rows
past ``accepted`` hold garbage K/V, overwritten by the next verify/decode
window before any query attends them.  Shapes never depend on acceptance.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as model_lib


def verify(params, cfg, cache, tokens, n_draft, active):
    """One verify dispatch.

    tokens (B, W) int32, n_draft (B,) int32, active (B,) bool, all on the
    cache's device.  Returns (cache, targets (B, W) int32, accepted (B,)
    int32); ``accepted`` counts accepted *drafts* (<= n_draft) and the
    caller emits ``targets[lane, :accepted + 1]``.  Inactive lanes keep
    pos = 0 and (paged) write to the trash page, as in plain decode.  The
    cache is updated in place."""
    logits, cache = model_lib.verify_step(params, cfg, tokens, cache, active)
    targets = torch.argmax(logits, dim=-1).to(torch.int32)
    width = tokens.shape[1]
    if width > 1:
        match = tokens[:, 1:] == targets[:, :-1]
        idx = torch.arange(width - 1, device=tokens.device)[None, :]
        ok = match & (idx < n_draft[:, None])
        accepted = torch.cumprod(ok.to(torch.int32), dim=1).sum(dim=1).to(torch.int32)
    else:
        accepted = torch.zeros((tokens.shape[0],), dtype=torch.int32, device=tokens.device)
    pos = cache["pos"]
    cache["pos"] = torch.where(active, pos + accepted + 1, torch.zeros_like(pos))
    return cache, targets, accepted
