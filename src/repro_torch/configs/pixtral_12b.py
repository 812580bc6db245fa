"""pixtral-12b [vlm] — Pixtral-ViT frontend (stubbed) + Mistral-Nemo
backbone. 40L d_model=5120 32H (GQA kv=8, head_dim=128) d_ff=14336
vocab=131072 [hf:mistralai/Pixtral-12B-2409]. The vision tower is a stub:
input_specs() feeds precomputed patch embeddings for the first
n_img_tokens positions."""
from repro_torch.models.common import ModelConfig

ARCH = "pixtral-12b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="vlm", n_layers=40, d_model=5120, d_ff=14336,
        vocab=131072, n_heads=32, n_kv=8, head_dim=128, mlp="swiglu",
        n_img_tokens=256, rope_theta=1e6,
        param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="vlm", n_layers=2, d_model=64,
        d_ff=128, vocab=256, n_heads=4, n_kv=2, head_dim=16, mlp="swiglu",
        n_img_tokens=8, max_seq=64)
