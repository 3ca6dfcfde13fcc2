"""Plain PyTorch version of the segment_mm kernel, on any device: the
message GEMM in float32, then a segment sum, as
``repro/kernels/segment_mm/ref.py`` computes it with
``jax.ops.segment_sum`` (here ``models/gnn/segment.py::scatter_sum_plain``,
one ``index_add_``: a plain version launches no kernel).
Like ``segment_sum``, it drops every edge whose
``dst`` lies outside ``[0, n_nodes)``; ``dst`` need not be sorted."""
from __future__ import annotations

import torch

from repro_torch.models.gnn.segment import scatter_sum_plain


def segment_matmul_ref(x_gathered, w, dst, *, n_nodes: int):
    """x_gathered (E, D_in), w (D_in, D_out), dst (E,) int ->
    (n_nodes, D_out) float32."""
    return scatter_sum_plain(x_gathered.float() @ w.float(), dst, n_nodes)
