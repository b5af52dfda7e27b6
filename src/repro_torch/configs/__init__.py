"""Architecture configurations: ``registry.get(name)`` resolves an
:class:`~repro_torch.configs.base.ArchConfig` by id."""
from repro_torch.configs.base import ArchConfig, reduced  # noqa: F401
from repro_torch.configs.registry import ARCH_IDS, all_configs, get  # noqa: F401
