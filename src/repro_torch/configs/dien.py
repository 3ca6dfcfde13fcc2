"""DIEN [arXiv:1809.03672; unverified]: embed 18, behavior seq 100,
GRU + AUGRU dim 108, MLP 200-80. Item/category vocab: Amazon-Books-scale
(367,983 items + 1,601 categories)."""
from repro_torch.configs.base import (ArchConfig, RECSYS_SHAPES,
                                      RecsysConfig, register)


def _model(**kw):
    base = dict(
        name="dien", kind="dien", n_dense=0, n_sparse=2, embed_dim=18,
        vocab_sizes=(367983, 1601), seq_len=100, gru_dim=108,
        mlp=(200, 80), interaction="augru", param_dtype="float32",
        compute_dtype="float32",
    )
    base.update(kw)
    return RecsysConfig(**base)


@register("dien")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="dien", family="recsys", model=_model(),
        shapes=RECSYS_SHAPES, source="arXiv:1809.03672; unverified",
        reduced=lambda: ArchConfig(
            arch_id="dien", family="recsys",
            model=_model(name="dien-tiny", vocab_sizes=(500, 20),
                         seq_len=10, gru_dim=12, mlp=(16, 8)),
            shapes=RECSYS_SHAPES, source="reduced"),
    )
