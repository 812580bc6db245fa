"""deepseek-v3-671b [moe] — 61L d_model=7168, MLA (q_lora=1536,
kv_lora=512, nope=128, rope=64, v=128, 128H), MoE 256 routed top-8 +
1 shared expert, expert d_ff=2048, first 3 layers dense (d_ff=18432),
vocab=129280 [arXiv:2412.19437]. MTP head is out of scope (architecture stub; docs/ARCHITECTURE.md)."""
from repro_torch.models.common import ModelConfig

ARCH = "deepseek-v3-671b"


def full() -> ModelConfig:
    return ModelConfig(
        name=ARCH, family="moe", n_layers=61, d_model=7168, d_ff=18432,
        vocab=129280, n_heads=128, n_kv=128, mla=True, kv_lora=512,
        q_lora=1536, rope_head_dim=64, nope_head_dim=128, v_head_dim=128,
        moe_experts=256, moe_topk=8, moe_shared=1, moe_dff=2048,
        moe_first_dense=3, param_dtype="bf16", activ_dtype="bf16")


def smoke() -> ModelConfig:
    return ModelConfig(
        name=ARCH + "-smoke", family="moe", n_layers=4, d_model=64,
        d_ff=192, vocab=256, n_heads=4, n_kv=4, mla=True, kv_lora=32,
        q_lora=48, rope_head_dim=16, nope_head_dim=32, v_head_dim=32,
        moe_experts=8, moe_topk=2, moe_shared=1, moe_dff=96,
        moe_first_dense=2, moe_capacity_factor=8.0, max_seq=64)
