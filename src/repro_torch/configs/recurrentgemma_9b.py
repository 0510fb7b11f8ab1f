"""recurrentgemma-9b [hybrid] — arXiv:2402.19427 (Griffin / RecurrentGemma).

38L, d_model 4096, 16 attention heads (MQA kv=1, head_dim 256), d_ff 12288,
vocab 256000; block pattern 2x RG-LRU recurrent : 1x local attention
(window 2048).  38 = 12 periods of 3 + 2 tail recurrent layers.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4_096,
    n_heads=16,
    n_kv_heads=1,
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local_attn"),
    sliding_window=2_048,
    lru_width=4_096,
)
