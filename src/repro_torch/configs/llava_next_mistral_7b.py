"""llava-next-mistral-7b [vlm] — hf:llava-hf/llava-v1.6-mistral-7b-hf.

Backbone = Mistral-7B: 32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336,
vocab 32000.  The anyres vision tower is a STUB per the assignment:
input_specs() feeds precomputed patch embeddings.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    n_layers=32,
    d_model=4_096,
    n_heads=32,
    n_kv_heads=8,
    head_dim=128,
    d_ff=14_336,
    vocab_size=32_000,
    rope_theta=1_000_000.0,
    frontend="vision",
)
