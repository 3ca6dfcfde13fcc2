"""EquiformerV2 [arXiv:2306.12059; unverified]: 12L d_hidden=128 l_max=6
m_max=2 8H, SO(2)-eSCN equivariant graph attention."""
from repro_torch.configs.base import (ArchConfig, GNNConfig, GNN_SHAPES,
                                      register)


def _model(**kw):
    base = dict(
        name="equiformer-v2", n_layers=12, d_hidden=128, l_max=6, m_max=2,
        n_heads=8, n_radial=32, d_in=0, n_out=1,
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    base.update(kw)
    return GNNConfig(**base)


@register("equiformer-v2")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="equiformer-v2", family="gnn", model=_model(),
        shapes=GNN_SHAPES, source="arXiv:2306.12059; unverified",
        reduced=lambda: ArchConfig(
            arch_id="equiformer-v2", family="gnn",
            model=_model(name="eq-tiny", n_layers=2, d_hidden=16, l_max=3,
                         m_max=2, n_heads=4, n_radial=8, d_in=7, n_out=3,
                         param_dtype="float32", compute_dtype="float32"),
            shapes=GNN_SHAPES, source="reduced"),
    )
