"""rwkv6-3b [ssm] — Finch: 32L d_model=2560, attention-free data-dependent
decay, d_ff=8960 vocab=65536, head dim 64 (40 heads) [arXiv:2404.05892]."""
from repro_torch.models.common import ModelConfig

ARCH = "rwkv6-3b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="rwkv", n_layers=32, d_model=2560, d_ff=8960,
        vocab=65536, ssm_head_dim=64,
        param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="rwkv", n_layers=2, d_model=64,
        d_ff=128, vocab=256, ssm_head_dim=16, max_seq=64)
