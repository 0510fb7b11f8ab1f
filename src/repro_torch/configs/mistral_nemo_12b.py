"""mistral-nemo-12b [dense] — hf:mistralai/Mistral-Nemo-Base-2407 (128k ctx).

40L, d_model 5120, 32 heads (GQA kv=8, head_dim 128), d_ff 14336,
vocab 131072, rope theta 1e6 for the 128k context.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-nemo-12b",
    family="dense",
    n_layers=40,
    d_model=5_120,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=131_072,
    rope_theta=1_000_000.0,
)
