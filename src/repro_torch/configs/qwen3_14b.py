"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, GQA.  [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ArchSpec, lm_shapes, register
from repro_torch.models.transformer import TransformerConfig


def build() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-14b", n_layers=40, d_model=5120, n_heads=40,
        n_kv_heads=8, d_head=128, d_ff=17408, vocab=151936,
        qk_norm=True, rope_theta=1e6)


def build_smoke() -> TransformerConfig:
    return TransformerConfig(
        name="qwen3-14b-smoke", n_layers=2, d_model=64, n_heads=5,
        n_kv_heads=1, d_head=16, d_ff=128, vocab=256, qk_norm=True)


ARCH = register(ArchSpec(
    name="qwen3-14b", family="lm", build=build, build_smoke=build_smoke,
    shapes=lm_shapes, source="hf:Qwen/Qwen3-8B; hf"))
