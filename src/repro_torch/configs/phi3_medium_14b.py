"""Phi-3-medium-14B [arXiv:2404.14219; unverified]: 40L d=5120 40H (kv=10)
d_ff=17920, vocab 100352, RoPE SwiGLU GQA."""
from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES, register


def _model(**kw):
    base = dict(
        name="phi3-medium-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=10, d_ff=17920, vocab_size=100352, rope_theta=1e4,
    )
    base.update(kw)
    return LMConfig(**base)


@register("phi3-medium-14b")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="phi3-medium-14b", family="lm", model=_model(),
        shapes=LM_SHAPES, source="arXiv:2404.14219; unverified",
        skips={"long_500k": "pure full attention; skipped per spec"},
        reduced=lambda: ArchConfig(
            arch_id="phi3-medium-14b", family="lm",
            model=_model(name="phi3-tiny", n_layers=2, d_model=64,
                         n_heads=8, n_kv_heads=2, d_ff=128, vocab_size=512,
                         param_dtype="float32", compute_dtype="float32"),
            shapes=LM_SHAPES, source="reduced"),
    )
