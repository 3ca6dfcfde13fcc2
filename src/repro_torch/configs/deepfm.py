"""DeepFM [arXiv:1703.04247; paper]: 39 sparse fields (13 binned-numeric +
26 categorical Criteo-Kaggle), embed 10, deep MLP 400-400-400, FM
interaction."""
from repro_torch.configs.base import (ArchConfig, RECSYS_SHAPES,
                                      RecsysConfig, register)

# 13 numeric features discretized to 100 bins each + Criteo-Kaggle
# categorical vocab sizes (standard preprocessing)
CRITEO_KAGGLE_VOCAB = (100,) * 13 + (
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572)


def _model(**kw):
    base = dict(
        name="deepfm", kind="deepfm", n_dense=0, n_sparse=39, embed_dim=10,
        vocab_sizes=CRITEO_KAGGLE_VOCAB, mlp=(400, 400, 400),
        interaction="fm", param_dtype="bfloat16", compute_dtype="bfloat16",
    )
    base.update(kw)
    return RecsysConfig(**base)


@register("deepfm")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="deepfm", family="recsys", model=_model(),
        shapes=RECSYS_SHAPES, source="arXiv:1703.04247; paper",
        reduced=lambda: ArchConfig(
            arch_id="deepfm", family="recsys",
            model=_model(name="deepfm-tiny", n_sparse=4, embed_dim=8,
                         vocab_sizes=(100, 50, 200, 30), mlp=(16, 16),
                         param_dtype="float32", compute_dtype="float32"),
            shapes=RECSYS_SHAPES, source="reduced"),
    )
