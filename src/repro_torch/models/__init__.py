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
  rwkv6.py       — RWKV-6 block: token shift, f32 data-dependent decay,
                   the per-step time-mix recurrence in the activation
                   dtype, the squared-ReLU channel mix
  mamba2.py      — Mamba-2 (SSD) block: depthwise causal conv, the
                   chunked scan in f32 (chunks of 128)
  transformer.py — init_params, embed_inputs / lm_logits (the vlm and
                   audio stubs), forward (train / prefill / decode),
                   loss_fn, pad_caches; the dense, vlm, audio, moe, rwkv
                   and hybrid families
"""
