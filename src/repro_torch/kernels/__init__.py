"""Hand-written CUDA kernels for Hopper and their plain PyTorch versions.

- ``decode_attention``: single-token attention over the serving pool
  (port of ``decode_attention_pallas``);
- ``flash_attention``: full-sequence causal, sliding-window or chunked
  attention, also at MLA's q.k 192 / v 128 head dims, with a gradient
  whose backward is plain PyTorch (port of ``flash_attention_pallas``);
- ``mla_decode``: DeepSeek-V2's absorbed MLA decode over the latent pool
  (replaces no Pallas kernel: the jnp einsums of ``mla_decode_slots``);
- ``gram``: cosine Gram matrices of node batches, with an analytic
  gradient (port of ``cosine_gram_pallas``);
- ``lora_matmul``: the fused GeoLoRA linear x @ W + (x @ A) @ B, whose
  input gradient launches the same kernel (port of
  ``lora_matmul_pallas``);
- ``selective_scan``: the diagonal recurrence of every Mamba and RG-LRU
  layer's prefill, h_t = da_t * h_{t-1} + dbx_t, forward only (port of
  ``selective_scan_pallas``).

The sources live in ``repro_torch/csrc/`` and are built on first use by
``kernels._build``.  Importing this package builds nothing.
"""
