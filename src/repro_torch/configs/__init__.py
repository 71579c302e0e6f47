"""The model zoo's configs, copied from ``repro/configs`` (data only)."""
from repro_torch.configs.registry import (ARCHS, get_config,  # noqa: F401
                                          list_archs, smoke_config)
