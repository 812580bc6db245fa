"""musicgen-large [audio] — decoder-only over EnCodec tokens: 48L
d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048, 4 codebooks
[arXiv:2306.05284]. Text-conditioning cross-attention is out of scope
(stub: unconditional decoder; see docs/ARCHITECTURE.md, "Model and
training integrations")."""
from repro_torch.models.common import ModelConfig

ARCH = "musicgen-large"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="audio", n_layers=48, d_model=2048, d_ff=8192,
        vocab=2048, n_heads=32, n_kv=32, head_dim=64, mlp="gelu",
        n_codebooks=4, param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="audio", n_layers=2, d_model=64,
        d_ff=128, vocab=64, n_heads=4, n_kv=4, head_dim=16, mlp="gelu",
        n_codebooks=4, max_seq=64)
