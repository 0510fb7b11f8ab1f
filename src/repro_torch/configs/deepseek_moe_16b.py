"""deepseek-moe-16b [moe] — arXiv:2401.06066 (DeepSeekMoE 16B).

28L, d_model 2048, 16 heads, 64 routed experts top-6 + 2 shared experts
(fine-grained, d_expert 1408), first layer dense (d_ff 10944),
vocab 102400.
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    n_layers=28,
    d_model=2_048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1_408,
    vocab_size=102_400,
    block_pattern=("moe",),
    moe=MoEConfig(
        num_experts=64,
        top_k=6,
        num_shared_experts=2,
        d_expert=1_408,
        first_k_dense=1,
        d_ff_dense=10_944,
    ),
)
