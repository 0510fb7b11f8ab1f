"""The port's data pipeline."""

from repro_torch.data.pipeline import SyntheticTokenPipeline, batch_specs

__all__ = ["SyntheticTokenPipeline", "batch_specs"]
