"""The model zoo, in torch (counterpart of ``repro/models``).

Modules:
  common.py      — ModelConfig, rms_norm, RoPE, MLPs, init
  common.py also holds cross_entropy, the LM loss
  attention.py   — GQA attention: flash-attention kernel for train and
                   prefill (FlashCausal: its gradient recomputes the
                   reference's scan), grouped product against the KV
                   cache for decode
  transformer.py — init_params, forward (train / prefill / decode),
                   loss_fn, pad_caches; the dense family only

The other families (vlm, audio, moe, rwkv, hybrid) are ROADMAP A12.
"""
