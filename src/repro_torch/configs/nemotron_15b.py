"""nemotron-4-15b [dense] — 32L d_model=6144 48H (GQA kv=8) d_ff=24576
vocab=256000, squared-ReLU MLP [arXiv:2402.16819]."""
from repro_torch.models.common import ModelConfig

ARCH = "nemotron-4-15b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=32, d_model=6144, d_ff=24576,
        vocab=256000, n_heads=48, n_kv=8, head_dim=128, mlp="relu2",
        rope_theta=1e6, param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=96,
        d_ff=192, vocab=256, n_heads=6, n_kv=2, head_dim=16, mlp="relu2",
        max_seq=64)
