"""PyTorch / CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` is the reference this port is held against.
Module paths mirror it (``repro_torch.core.affine`` is the counterpart of
``repro.core.affine``, and so on).  The port imports ``torch`` and never
``jax``, and nothing of ``repro``.

What is ported so far is the serving path of the ActorQ policy, the
sequence actor's rollout path, the DQN learner with QAT, and LM inference
(prefill and greedy decode) for the dense-attention configs:

* ``core``       -- the paper's affine quantizer, the int8/int4 pack, the
  symmetric KV-cache token quantizer, PTQ simulation, fake quantization
  with the straight-through estimator and range observers (QAT), the
  quantization config and the study metrics;
* ``kernels``    -- the W8A8/W4A8 GEMM (``int8_matmul``), the fused
  quantized MLP (``fused_qmlp``), the decode attention over an int8
  KV cache (``int8_cache_attention``), the fake quantizer
  (``fake_quant``) and the flash attention of prefill
  (``flash_attention``), each a hand-written CUDA kernel for ``sm_90a``
  beside its plain PyTorch version;
* ``configs``    -- h2o-danube-1.8b and gemma2-9b (and their reduced
  variants);
* ``models``     -- the decoder-transformer sequence policy, and the LM
  (attention with GQA, RoPE, windows, soft-caps and fp / int8 KV caches;
  the SwiGLU block; ``transformer.prefill`` and ``decode_step``);
* ``optim``      -- Adam with global-norm clipping (fp32);
* ``rl``         -- AirNav, CartPole, Catch and the frame-stacking
  wrappers, the QAT-aware MLP and the sequence policy, the packed actor
  (MLP and KV-cache decode), rollouts with auto-reset, evaluation,
  uniform replay, DQN (behaviour policy, TD update, iteration), the
  fused training loop and the QuaRL PTQ/QAT pipelines;
* ``launch``     -- ``python -m repro_torch.launch.train --mode rl`` and
  ``python -m repro_torch.launch.serve`` (LM greedy decoding);
* ``serving``    -- ``PolicyServer``: shape buckets, hot-swap, worker loop;
* ``resilience`` -- the CRC and structural guards the server uses.

Entry points run on the card unless the caller asks for the CPU.
"""
