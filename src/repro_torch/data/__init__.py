"""Data pipelines of the port: batches made with numpy from (seed, step)."""
from repro_torch.data.pipeline import (SyntheticImageData,  # noqa: F401
                                       SyntheticLMData, TokenFileData,
                                       make_pipeline)
