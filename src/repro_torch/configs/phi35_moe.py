"""phi3.5-moe-42b-a6.6b [moe]: 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, MoE 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct; hf]"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def build() -> TransformerConfig:
    return TransformerConfig(
        name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_heads=32,
        n_kv_heads=8, d_head=128, d_ff=6400, vocab=32064,
        n_experts=16, top_k=2, rope_theta=10000.0)


def build_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="phi3.5-moe-smoke", n_layers=2, d_model=64, n_heads=4,
        n_kv_heads=2, d_head=16, d_ff=96, vocab=256,
        n_experts=8, top_k=2, moe_group_size=64)


ARCH = register(ArchSpec(
    name="phi3.5-moe-42b-a6.6b", family="lm", build=build,
    build_smoke=build_smoke, shapes=lm_shapes,
    source="hf:microsoft/Phi-3.5-MoE-instruct; hf"))
