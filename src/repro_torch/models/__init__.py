"""The model zoo, in torch (counterpart of ``repro/models``).

Modules:
  common.py      — ModelConfig, rms_norm, RoPE, MLPs, init
  attention.py   — GQA attention: flash-attention kernel for prefill,
                   grouped product against the KV cache for decode
  transformer.py — init_params, forward (train / prefill / decode),
                   pad_caches; the dense family only

The other families (vlm, audio, moe, rwkv, hybrid) are ROADMAP A12.
"""
