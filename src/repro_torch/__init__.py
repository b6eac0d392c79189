"""PyTorch / CUDA port of the ``repro`` package, for one NVIDIA H100.

The JAX package ``repro`` is the reference this port is held against.
Module paths mirror it (``repro_torch.core.affine`` is the counterpart of
``repro.core.affine``, and so on).  The port imports ``torch`` and never
``jax``, and nothing of ``repro``.

What is ported so far is the serving path of the ActorQ policy:

* ``core``       -- the paper's affine quantizer and the int8/int4 pack;
* ``kernels``    -- the W8A8/W4A8 GEMM (``int8_matmul``) and the fused
  quantized MLP (``fused_qmlp``), each a hand-written CUDA kernel for
  ``sm_90a`` beside its plain PyTorch version;
* ``rl``         -- the AirNav env, the MLP policy and the packed actor;
* ``serving``    -- ``PolicyServer``: shape buckets, hot-swap, worker loop;
* ``resilience`` -- the CRC and structural guards the server uses.

Entry points run on the card unless the caller asks for the CPU.
"""
