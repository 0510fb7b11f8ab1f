"""mistral-large-123b [dense] — hf:mistralai/Mistral-Large-Instruct-2407.

88L, d_model 12288, 96 heads (GQA kv=8), d_ff 28672, vocab 32768.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="mistral-large-123b",
    family="dense",
    n_layers=88,
    d_model=12_288,
    n_heads=96,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28_672,
    vocab_size=32_768,
    rope_theta=1_000_000.0,
)
