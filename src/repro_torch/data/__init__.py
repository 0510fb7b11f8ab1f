"""The port's data pipeline."""

from repro_torch.data.pipeline import SyntheticTokenPipeline

__all__ = ["SyntheticTokenPipeline"]
