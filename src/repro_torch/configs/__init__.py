"""Arch registry: importing this package registers the port's configs."""
from repro_torch.configs import (adaparse_router, dlrm_mlperf,  # noqa: F401
                                 h2o_danube_3_4b, qwen3_1p7b)
from repro_torch.configs.base import ArchConfig, get_config  # noqa: F401
