"""mixtral-8x7b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000,
MoE 8 experts top-2, sliding-window attention.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def build() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x7b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, rope_theta=1e6, sliding_window=4096)


def build_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="mixtral-8x7b-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
        n_experts=4, top_k=2, sliding_window=32, moe_group_size=64)


ARCH = register(ArchSpec(
    name="mixtral-8x7b", family="lm", build=build, build_smoke=build_smoke,
    shapes=lm_shapes, source="arXiv:2401.04088; hf"))
