from repro_torch.kernels.fast_features.ops import (fast_features,
                                                   pack_routing_batch,
                                                   routing_features)
from repro_torch.kernels.fast_features.ref import fast_features_ref
