"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — 2-D RoPE, GQA.  [arXiv:2406.12793; hf]"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def build() -> TransformerConfig:
    return TransformerConfig(
        name="chatglm3-6b", n_layers=28, d_model=4096, n_heads=32,
        n_kv_heads=2, d_head=128, d_ff=13696, vocab=65024,
        rope_style="2d", rotary_pct=0.5)


def build_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="chatglm3-6b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        rope_style="2d", rotary_pct=0.5)


ARCH = register(ArchSpec(
    name="chatglm3-6b", family="lm", build=build, build_smoke=build_smoke,
    shapes=lm_shapes, source="arXiv:2406.12793; hf"))
