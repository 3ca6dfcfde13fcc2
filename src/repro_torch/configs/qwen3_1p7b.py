"""Qwen3-1.7B [hf:Qwen/Qwen3-8B; hf]: 28L d=2048 16H (kv=8) d_ff=6144,
vocab 151936, qk-norm, GQA."""
from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES, register


def _model(**kw):
    base = dict(
        name="qwen3-1.7b", n_layers=28, d_model=2048, n_heads=16,
        n_kv_heads=8, d_ff=6144, vocab_size=151936, rope_theta=1e6,
        qk_norm=True,
    )
    base.update(kw)
    return LMConfig(**base)


@register("qwen3-1.7b")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="qwen3-1.7b", family="lm", model=_model(),
        shapes=LM_SHAPES, source="hf:Qwen/Qwen3-8B; hf",
        skips={"long_500k": "pure full attention; skipped per spec"},
        reduced=lambda: ArchConfig(
            arch_id="qwen3-1.7b", family="lm",
            model=_model(name="qwen3-tiny", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                         param_dtype="float32", compute_dtype="float32"),
            shapes=LM_SHAPES, source="reduced"),
    )
