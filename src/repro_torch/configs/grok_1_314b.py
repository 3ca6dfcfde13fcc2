"""Grok-1 314B [hf:xai-org/grok-1; unverified]: 64L d=6144 48H (kv=8)
MoE 8e top-2, d_ff=32768, vocab 131072. Trains with Adafactor, as in the
JAX package (``launch/specs._optimizer_for``)."""
from repro_torch.configs.base import (ArchConfig, LMConfig, LM_SHAPES, MoEConfig,
                                register)


def _model(**kw):
    base = dict(
        name="grok-1-314b", n_layers=64, d_model=6144, n_heads=48,
        n_kv_heads=8, d_ff=32768, vocab_size=131072, rope_theta=1e4,
        logits_softcap=30.0,               # grok uses output softcap
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32768),
        q_chunk=1024, kv_chunk=2048,
    )
    base.update(kw)
    return LMConfig(**base)


@register("grok-1-314b")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="grok-1-314b", family="lm", model=_model(),
        shapes=LM_SHAPES, source="hf:xai-org/grok-1; unverified",
        skips={"long_500k": "pure full attention; skipped per spec"},
        reduced=lambda: ArchConfig(
            arch_id="grok-1-314b", family="lm",
            model=_model(name="grok-tiny", n_layers=2, d_model=64,
                         n_heads=8, n_kv_heads=2, d_ff=128,
                         vocab_size=512, logits_softcap=30.0,
                         moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=64),
                         q_chunk=512, kv_chunk=1024,
                         param_dtype="float32", compute_dtype="float32"),
            shapes=LM_SHAPES, source="reduced"),
    )
