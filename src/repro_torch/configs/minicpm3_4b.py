"""minicpm3-4b [dense, MLA] — hf:openbmb/MiniCPM3-4B.

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448, Multi-head Latent
Attention (q_lora 768, kv_lora 256, nope 64 + rope 32, v 64).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig

CONFIG = ModelConfig(
    name="minicpm3-4b",
    family="dense",
    n_layers=62,
    d_model=2_560,
    n_heads=40,
    n_kv_heads=40,
    head_dim=96,  # qk_nope + qk_rope
    d_ff=6_400,
    vocab_size=73_448,
    use_mla=True,
    mla=MLAConfig(
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
    ),
)
