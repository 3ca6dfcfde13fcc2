"""Feature-interaction ops, the port of
``repro/models/recsys/interactions.py``: the DLRM dot interaction. FM,
AutoInt and the DIEN GRUs are not ported yet (ROADMAP.md queue 1, item
13e)."""
from __future__ import annotations

import torch


def dot_interaction(vecs: torch.Tensor,
                    keep_self: bool = False) -> torch.Tensor:
    """DLRM pairwise dots. vecs (B, F, D) -> (B, F*(F-1)/2 [+F])."""
    f = vecs.shape[1]
    g = torch.einsum("bfd,bgd->bfg", vecs, vecs)
    iu, ju = torch.triu_indices(f, f, offset=0 if keep_self else 1,
                                device=vecs.device)
    return g[:, iu, ju]
