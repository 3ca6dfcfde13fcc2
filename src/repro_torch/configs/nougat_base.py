"""Nougat-class high-quality parser (Swin-encoder + mBART-decoder,
Blecher et al. 2023), the expensive path of AdaParse. Page-batched at
B_p=10 pages (paper §5.2), fixed (896, 672) input.

Shapes: training (page-image -> text CE), the serve encode step (page
batch through encoder + cross-KV precompute), and the serve decode step
(one token for a large in-flight page batch)."""
from repro_torch.configs.base import (ArchConfig, ShapeConfig,
                                      VitParserConfig, register)

NOUGAT_SHAPES = (
    ShapeConfig("train_pages", "train",
                {"global_batch": 256, "dec_len": 2048},
                note="pages per step; teacher-forced CE"),
    ShapeConfig("parse_encode", "serve",
                {"global_batch": 2560, "dec_len": 0},
                note="encoder fwd for 256 docs x B_p=10 pages"),
    ShapeConfig("parse_decode", "decode",
                {"global_batch": 2560, "dec_len": 2048},
                note="one decode token against 2048-cache, batch=pages"),
)


def _model(**kw):
    base = dict(
        name="nougat-base", enc_layers=12, enc_d_model=1024, enc_heads=16,
        enc_d_ff=4096, window=112,          # 2352 patches / 21 windows
        image_hw=(896, 672), patch=16,
        dec_layers=10, dec_d_model=1024, dec_heads=16, dec_d_ff=4096,
        vocab_size=50000, max_dec_len=4096, pages_per_batch=10,
    )
    base.update(kw)
    return VitParserConfig(**base)


@register("nougat-base")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="nougat-base", family="vit_parser", model=_model(),
        shapes=NOUGAT_SHAPES, source="paper (Nougat, arXiv:2308.13418)",
        reduced=lambda: ArchConfig(
            arch_id="nougat-base", family="vit_parser",
            model=_model(name="nougat-tiny", enc_layers=2, enc_d_model=32,
                         enc_heads=4, enc_d_ff=64, window=8,
                         image_hw=(64, 48), dec_layers=2, dec_d_model=32,
                         dec_heads=4, dec_d_ff=64, vocab_size=64,
                         max_dec_len=16, param_dtype="float32",
                         compute_dtype="float32"),
            shapes=NOUGAT_SHAPES, source="reduced"),
    )
