from repro_torch.kernels.segment_mm.ops import (segment_matmul,
                                                segment_matmul_kernel)
from repro_torch.kernels.segment_mm.ref import segment_matmul_ref
