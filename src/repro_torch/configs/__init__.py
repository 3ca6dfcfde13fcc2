"""Arch registry: importing this package registers the port's configs."""
from repro_torch.configs import (adaparse_router, dlrm_mlperf,  # noqa: F401
                                 grok_1_314b, h2o_danube_3_4b, olmoe_1b_7b,
                                 phi3_medium_14b, qwen3_1p7b)
from repro_torch.configs.base import ArchConfig, get_config  # noqa: F401
