"""Speculative decoding for the port's serving engine (``repro/spec/``).

``k`` drafted tokens per lane are verified in ONE batched model dispatch
(more byte-size GEMM work per issued operation), with the greedy accept
rule applied to that dispatch's logits, so speculative output stays
bitwise identical to plain decode.  See ``verify.py`` for the accept rule,
``ngram.py`` / ``draft_model.py`` for the two drafters.
"""

from repro_torch.spec.config import DRAFTERS, SpecConfig
from repro_torch.spec.ngram import NgramDrafter
from repro_torch.spec.verify import verify


def make_drafter(spec: SpecConfig, target_cfg, n_slots: int, cache_len: int, tree=None,
                 device=None):
    """Build the configured drafter (the draft model is imported lazily so
    the n-gram path never touches model code)."""
    if spec.drafter == "ngram":
        return NgramDrafter(spec, tree=tree)
    from repro_torch.spec.draft_model import DraftModelDrafter

    return DraftModelDrafter(spec, target_cfg, n_slots, cache_len, device=device)


__all__ = ["DRAFTERS", "NgramDrafter", "SpecConfig", "make_drafter", "verify"]
