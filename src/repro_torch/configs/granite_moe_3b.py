"""granite-moe-3b-a800m [moe] — ibm-granite granite-3.0 MoE family.

32L, d_model 1536, 24 heads (GQA kv=8), per-expert d_ff 512, vocab 49155,
40 routed experts top-8.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1_536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    vocab_size=49_155,
    block_pattern=("moe",),
    moe=MoEConfig(num_experts=40, top_k=8, d_expert=512),
)
