"""Arch registry: importing this package registers the port's configs."""
from repro_torch.configs import (adaparse_router, autoint,  # noqa: F401
                                 deepfm, dien, dlrm_mlperf, equiformer_v2,
                                 grok_1_314b, h2o_danube_3_4b, nougat_base,
                                 olmoe_1b_7b, phi3_medium_14b, qwen3_1p7b)
from repro_torch.configs.base import (ArchConfig, get_config,  # noqa: F401
                                      list_archs)
