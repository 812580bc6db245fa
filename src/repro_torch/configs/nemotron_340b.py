"""nemotron-4-340b [dense] — 96L d_model=18432 96H (GQA kv=8, head_dim
192) d_ff=73728 vocab=256000, squared-ReLU [arXiv:2402.16819]."""
from repro_torch.models.common import ModelConfig

ARCH = "nemotron-4-340b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=96, d_model=18432, d_ff=73728,
        vocab=256000, n_heads=96, n_kv=8, head_dim=192, mlp="relu2",
        rope_theta=1e6, param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=3, d_model=96,
        d_ff=384, vocab=256, n_heads=6, n_kv=2, head_dim=16, mlp="relu2",
        max_seq=64)
