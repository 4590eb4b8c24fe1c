from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, get_config, long_context_ok  # noqa: F401
