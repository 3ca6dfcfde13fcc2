"""Arch registry: importing this package registers the port's configs."""
from repro_torch.configs import adaparse_router  # noqa: F401
from repro_torch.configs.base import ArchConfig, get_config  # noqa: F401
