"""DLRM MLPerf [arXiv:1906.00091; paper]: Criteo-1TB config, 13 dense +
26 sparse fields, embed 128, bot 13-512-256-128, top 1024-1024-512-256-1,
dot interaction. Table sizes: the MLPerf max-40M-row Criteo-TB list
(187,767,399 rows in all, 187,767,808 once padded to 512: 48.07 GB in
bf16, 96.14 GB in fp32)."""
from repro_torch.configs.base import (ArchConfig, RECSYS_SHAPES,
                                      RecsysConfig, register)

CRITEO_TB_VOCAB = (
    39884406, 39043, 17289, 7420, 20263, 3, 7120, 1543, 63, 38532951,
    2953546, 403346, 10, 2208, 11938, 155, 4, 976, 14, 39979771, 25641295,
    39664984, 585935, 12972, 108, 36)


def _model(**kw):
    base = dict(
        name="dlrm-mlperf", kind="dlrm", n_dense=13, n_sparse=26,
        embed_dim=128, vocab_sizes=CRITEO_TB_VOCAB,
        bot_mlp=(512, 256, 128), top_mlp=(1024, 1024, 512, 256, 1),
        interaction="dot", param_dtype="bfloat16",
        compute_dtype="bfloat16",
    )
    base.update(kw)
    return RecsysConfig(**base)


@register("dlrm-mlperf")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="dlrm-mlperf", family="recsys", model=_model(),
        shapes=RECSYS_SHAPES, source="arXiv:1906.00091; paper",
        reduced=lambda: ArchConfig(
            arch_id="dlrm-mlperf", family="recsys",
            model=_model(name="dlrm-tiny", n_dense=5, n_sparse=4,
                         embed_dim=8, vocab_sizes=(100, 50, 200, 30),
                         bot_mlp=(16, 8), top_mlp=(32, 16, 1),
                         param_dtype="float32", compute_dtype="float32"),
            shapes=RECSYS_SHAPES, source="reduced"),
    )
