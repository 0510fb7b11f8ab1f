"""seamless-m4t-large-v2 [audio] — arXiv:2308.11596 (SeamlessM4T v2).

Encoder-decoder backbone: 24L encoder + 24L decoder, d_model 1024,
16 heads, d_ff 8192, vocab 256206.  Speech frontend is a STUB:
input_specs() feeds precomputed frame embeddings to the encoder.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    d_model=1_024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=8_192,
    vocab_size=256_206,
    is_encoder_decoder=True,
    n_encoder_layers=24,
    frontend="audio",
)
