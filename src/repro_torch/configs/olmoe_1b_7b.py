"""OLMoE-1B-7B [arXiv:2409.02060; hf]: 16L d=2048 16H (kv=16) MoE 64e top-8,
d_ff_expert=1024, vocab 50304."""
import dataclasses

from repro_torch.configs.base import (ArchConfig, LMConfig, LM_SHAPES, MoEConfig,
                                register)


def _model(**kw):
    base = dict(
        name="olmoe-1b-7b", n_layers=16, d_model=2048, n_heads=16,
        n_kv_heads=16, d_ff=1024, vocab_size=50304, rope_theta=1e4,
        qk_norm=True,                      # OLMoE uses QK-norm
        moe=MoEConfig(n_experts=64, top_k=8, d_ff_expert=1024),
    )
    base.update(kw)
    return LMConfig(**base)


@register("olmoe-1b-7b")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="olmoe-1b-7b", family="lm", model=_model(), shapes=LM_SHAPES,
        source="arXiv:2409.02060; hf",
        skips={"long_500k": "pure full attention (no sub-quadratic path); "
                            "skipped per spec, see DESIGN.md"},
        reduced=lambda: ArchConfig(
            arch_id="olmoe-1b-7b", family="lm",
            model=_model(name="olmoe-tiny", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=4, d_ff=64, vocab_size=512,
                         moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=32),
                         param_dtype="float32", compute_dtype="float32"),
            shapes=LM_SHAPES, source="reduced"),
    )
