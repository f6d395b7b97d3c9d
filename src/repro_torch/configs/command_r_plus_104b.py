"""command-r-plus-104b [dense]: 64L d_model=12288 96H (GQA kv=8)
d_ff=33792 vocab=256000 — GQA, no-bias.  [hf:CohereForAI/c4ai-command-r-v01;
unverified]"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def build() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
        n_kv_heads=8, d_head=128, d_ff=33792, vocab=256000,
        rope_theta=75e6, tie_embeddings=True)


def build_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="command-r-plus-smoke", n_layers=2, d_model=64, n_heads=6,
        n_kv_heads=2, d_head=16, d_ff=160, vocab=256, tie_embeddings=True)


ARCH = register(ArchSpec(
    name="command-r-plus-104b", family="lm", build=build,
    build_smoke=build_smoke, shapes=lm_shapes,
    source="hf:CohereForAI/c4ai-command-r-v01; unverified"))
