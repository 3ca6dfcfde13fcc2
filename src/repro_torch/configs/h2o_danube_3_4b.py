"""H2O-Danube-3-4B [arXiv:2401.16818; unverified]: 24L d=3840 32H (kv=8)
d_ff=10240, vocab 32000, llama+mistral mix with sliding-window attention
(window 4096) — the one LM arch that runs long_500k (sub-quadratic)."""
from repro_torch.configs.base import ArchConfig, LMConfig, LM_SHAPES, register


def _model(**kw):
    base = dict(
        name="h2o-danube-3-4b", n_layers=24, d_model=3840, n_heads=32,
        n_kv_heads=8, d_ff=10240, vocab_size=32000, rope_theta=1e4,
        sliding_window=4096,
    )
    base.update(kw)
    return LMConfig(**base)


@register("h2o-danube-3-4b")
def config() -> ArchConfig:
    return ArchConfig(
        arch_id="h2o-danube-3-4b", family="lm", model=_model(),
        shapes=LM_SHAPES, source="arXiv:2401.16818; unverified",
        reduced=lambda: ArchConfig(
            arch_id="h2o-danube-3-4b", family="lm",
            model=_model(name="danube-tiny", n_layers=2, d_model=64,
                         n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=512,
                         sliding_window=32, param_dtype="float32",
                         compute_dtype="float32"),
            shapes=LM_SHAPES, source="reduced"),
    )
