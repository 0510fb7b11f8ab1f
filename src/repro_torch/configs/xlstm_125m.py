"""xlstm-125m [ssm] — arXiv:2405.04517 (xLSTM).

12L, d_model 768, 4 heads, vocab 50304; mLSTM (matrix memory) with one
sLSTM (scalar memory, recurrent R) every 4th layer — the paper's
mLSTM:sLSTM ratio. d_ff=0: xLSTM cells carry their own projections.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    head_dim=192,
    d_ff=0,
    vocab_size=50_304,
    block_pattern=("mlstm", "mlstm", "mlstm", "slstm"),
)
