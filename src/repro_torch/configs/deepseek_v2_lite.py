"""deepseek-v2-lite-16b [moe] — 27L d_model=2048, MLA (kv_lora=512,
nope=128, rope=64, v=128, 16H), MoE 64 routed top-6 + 2 shared experts,
expert d_ff=1408, first layer dense (d_ff=10944), vocab=102400
[arXiv:2405.04434]."""
from repro_torch.models.common import ModelConfig

ARCH = "deepseek-v2-lite-16b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=27, d_model=2048, d_ff=10944,
        vocab=102400, n_heads=16, n_kv=16, mla=True, kv_lora=512, q_lora=0,
        rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        moe_experts=64, moe_topk=6, moe_shared=2, moe_dff=1408,
        moe_first_dense=1, param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe", n_layers=3, d_model=64,
        d_ff=192, vocab=256, n_heads=4, n_kv=4, mla=True, kv_lora=32,
        q_lora=0, rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
        moe_experts=8, moe_topk=2, moe_shared=2, moe_dff=96,
        moe_first_dense=1, moe_capacity_factor=8.0, max_seq=64)
