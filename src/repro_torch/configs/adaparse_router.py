"""AdaParse CLS-III router: SciBERT-class encoder (12L d=768 12H, ~110M)
with the m=6 per-parser accuracy head (the paper's own model; §5.1,
App. A/B). Shapes: SFT regression training, DPO pair training, and the
production route step (encoder fwd + alpha-budget dispatch)."""
from repro_torch.configs.base import ArchConfig, EncoderConfig, ShapeConfig, register

ROUTER_SHAPES = (
    ShapeConfig("sft_4k", "train", {"global_batch": 4096, "seq_len": 512},
                note="stage-1/3 accuracy regression"),
    ShapeConfig("dpo_2k", "train", {"global_batch": 2048, "seq_len": 512},
                note="stage-2 DPO pairs (2x fwd per side + ref)"),
    ShapeConfig("route_64k", "serve", {"global_batch": 65536, "seq_len": 512},
                note="fused route step: encoder + budget top-k dispatch"),
)


def _model(**kw):
    base = dict(
        name="adaparse-router", n_layers=12, d_model=768, n_heads=12,
        d_ff=3072, vocab_size=31090,        # SciBERT scivocab size
        max_len=512, n_outputs=6,
    )
    base.update(kw)
    return EncoderConfig(**base)


@register("adaparse-router")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="adaparse-router", family="encoder", model=_model(),
        shapes=ROUTER_SHAPES, source="paper (SciBERT, arXiv:1903.10676)",
        reduced=lambda: ArchConfig(
            arch_id="adaparse-router", family="encoder",
            model=_model(name="router-tiny", n_layers=2, d_model=32,
                         n_heads=4, d_ff=64, vocab_size=10000, max_len=64,
                         param_dtype="float32", compute_dtype="float32"),
            shapes=ROUTER_SHAPES, source="reduced"),
    )
