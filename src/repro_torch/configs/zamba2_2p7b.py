"""zamba2-2.7b [hybrid] — 54 Mamba-2 blocks (d_model=2560, ssm_state=64)
with one param-shared attention+MLP block applied every 9 blocks
(32H kv=32, d_ff=10240) [arXiv:2411.15242]."""
from repro_torch.models.common import ModelConfig

ARCH = "zamba2-2.7b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="hybrid", n_layers=54, d_model=2560, d_ff=10240,
        vocab=32000, n_heads=32, n_kv=32, head_dim=80, mlp="geglu",
        ssm_state=64, ssm_head_dim=64, attn_every=9,
        param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="hybrid", n_layers=4, d_model=64,
        d_ff=128, vocab=256, n_heads=4, n_kv=4, head_dim=16, mlp="geglu",
        ssm_state=16, ssm_head_dim=16, attn_every=2, max_seq=64)
