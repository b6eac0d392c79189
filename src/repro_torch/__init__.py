"""PyTorch / CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` is the reference this port is held against.
Module paths mirror it (``repro_torch.core.affine`` is the counterpart of
``repro.core.affine``, and so on).  The port imports ``torch`` and never
``jax``, and nothing of ``repro``.

What is ported so far is the serving path of the ActorQ policy and the
sequence actor's rollout path:

* ``core``       -- the paper's affine quantizer, the int8/int4 pack and
  the symmetric KV-cache token quantizer;
* ``kernels``    -- the W8A8/W4A8 GEMM (``int8_matmul``), the fused
  quantized MLP (``fused_qmlp``) and the decode attention over an int8
  KV cache (``int8_cache_attention``), each a hand-written CUDA kernel
  for ``sm_90a`` beside its plain PyTorch version;
* ``models``     -- the decoder-transformer sequence policy;
* ``rl``         -- AirNav, Catch and the frame-stacking wrappers, the MLP
  and sequence policies, the packed actor (MLP and KV-cache decode),
  rollouts with auto-reset, evaluation and DQN's behaviour policy;
* ``serving``    -- ``PolicyServer``: shape buckets, hot-swap, worker loop;
* ``resilience`` -- the CRC and structural guards the server uses.

Entry points run on the card unless the caller asks for the CPU.
"""
