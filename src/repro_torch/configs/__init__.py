from repro_torch.configs.base import ArchConfig, InputShape, SHAPES  # noqa: F401
from repro_torch.configs.registry import get_config, get_smoke_config, list_archs  # noqa: F401
