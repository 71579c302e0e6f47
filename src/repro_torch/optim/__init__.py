"""Optimizers of the port (``optim.adamw``)."""
from repro_torch.optim.adamw import AdamW, clip_by_global_norm  # noqa: F401
