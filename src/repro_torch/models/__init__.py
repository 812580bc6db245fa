"""The model zoo, in torch (counterpart of ``repro/models``).

Modules:
  common.py      — ModelConfig, rms_norm, RoPE, MLPs, init
  common.py also holds cross_entropy, the LM loss
  attention.py   — GQA attention: flash-attention kernel for train and
                   prefill (FlashCausal: its gradient recomputes the
                   reference's scan), grouped product against the KV
                   cache for decode
  mla.py         — Multi-head Latent Attention (deepseek): flash kernel
                   for prefill at head dim dn + dr, absorbed f32 decode
                   against the latent cache
  moe.py         — shared + routed experts: f32 router, stable sort by
                   expert, one product per expert on its rows, combine in
                   a fixed order
  transformer.py — init_params, embed_inputs / lm_logits (the vlm and
                   audio stubs), forward (train / prefill / decode),
                   loss_fn, pad_caches; the dense, vlm, audio and moe
                   families

The recurrent families (rwkv, hybrid) are ROADMAP A12.
"""
