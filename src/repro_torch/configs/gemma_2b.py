"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1, head_dim=256)
d_ff=16384, GeGLU, vocab=256000 [arXiv:2403.08295]."""
from repro_torch.models.common import ModelConfig

ARCH = "gemma-2b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=18, d_model=2048, d_ff=16384,
        vocab=256000, n_heads=8, n_kv=1, head_dim=256, mlp="geglu",
        param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
        d_ff=256, vocab=256, n_heads=4, n_kv=1, head_dim=32, mlp="geglu",
        max_seq=64)
