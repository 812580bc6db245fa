"""granite-34b [dense/code] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152, gpt-bigcode lineage => plain GELU 4x MLP [arXiv:2405.04324]."""
from repro_torch.models.common import ModelConfig

ARCH = "granite-34b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="dense", n_layers=88, d_model=6144, d_ff=24576,
        vocab=49152, n_heads=48, n_kv=1, head_dim=128, mlp="gelu",
        param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="dense", n_layers=2, d_model=64,
        d_ff=256, vocab=256, n_heads=4, n_kv=1, head_dim=16, mlp="gelu",
        max_seq=64)
