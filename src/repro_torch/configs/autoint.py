"""AutoInt [arXiv:1810.11921; paper]: 39 sparse fields, embed 16, 3
self-attention layers, 2 heads, d_attn 32."""
from repro_torch.configs.base import (ArchConfig, RECSYS_SHAPES,
                                      RecsysConfig, register)
from repro_torch.configs.deepfm import CRITEO_KAGGLE_VOCAB


def _model(**kw):
    base = dict(
        name="autoint", kind="autoint", n_dense=0, n_sparse=39,
        embed_dim=16, vocab_sizes=CRITEO_KAGGLE_VOCAB, n_attn_layers=3,
        n_attn_heads=2, d_attn=32, interaction="self-attn",
        param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    base.update(kw)
    return RecsysConfig(**base)


@register("autoint")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="autoint", family="recsys", model=_model(),
        shapes=RECSYS_SHAPES, source="arXiv:1810.11921; paper",
        reduced=lambda: ArchConfig(
            arch_id="autoint", family="recsys",
            model=_model(name="autoint-tiny", n_sparse=4, embed_dim=8,
                         vocab_sizes=(100, 50, 200, 30), n_attn_layers=2,
                         n_attn_heads=2, d_attn=8, param_dtype="float32",
                         compute_dtype="float32"),
            shapes=RECSYS_SHAPES, source="reduced"),
    )
