"""ActorQ: the packed int8/int4 actor of the port (MLP, conv and
sequence policies).

Counterpart of ``repro/rl/actorq.py`` (lines 85-554).  fp32 policy params
are packed once per push into an int cache (``pack_actor_params``); the
actor forward then runs every dense layer through the W8A8 / W4A8 integer
GEMM (``kernels.ops.int8_matmul``, kernel B1 on the card) with dynamic
per-tensor activation quantization, or -- once ``calibrate_actor_cache``
has attached static activation params -- the whole MLP in one launch
(``kernels.ops.fused_qmlp``, kernel B2).

Conv caches (``conv*`` keys: the paper's Atari backbone) run each conv
through the same GEMM by an im2col lowering (``int8_conv2d``): per-output-
channel int8 codes, the patch matrix quantized per tensor, the
per-channel scales in B1's per-column epilogue.  They never calibrate, so
they always take the per-layer path.

The calibrated path is the dynamic path on the calibration batch, bit for
bit: the static params are exactly those the dynamic quantizer derives at
each layer, and the fused epilogue repeats the per-layer float op order.

Sequence-policy caches (an ``embed`` key) run the decoder transformer:
windowed (``quantized_seq_apply``, for eval) or one token at a time on a
per-env int8 KV cache (``quantized_seq_step``, the rollout hot path),
whose attention is ``kernels.ops.int8_cache_attention`` (kernel B3 on the
card).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core import affine, ptq
from repro_torch.core.ptq import PackedTensor
from repro_torch.core.qconfig import QuantConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.fused_qmlp import QMLPLayer
from repro_torch.models import common as mcommon
from repro_torch.models.seq_policy import NEG_INF, valid_mask
from repro_torch.rl.env import attach_policy_state

QuantizedParams = Any

ACTOR_BACKENDS = ("fp32", "int8", "int4")
QUANTIZED_BACKENDS = ("int8", "int4")
_BACKEND_BITS = {"int8": 8, "int4": 4}

# key of the static activation params a calibrated cache carries
ACT_QUANT = "act_quant"


def validate_actor_backend(actor_backend: str) -> str:
    """Return ``actor_backend`` if it is one of ``ACTOR_BACKENDS``, else
    raise ``ValueError``."""
    if actor_backend not in ACTOR_BACKENDS:
        raise ValueError(f"actor_backend must be one of {ACTOR_BACKENDS}, "
                         f"got {actor_backend!r}")
    return actor_backend


def is_quantized(actor_backend: str) -> bool:
    """True for the integer-inference backends (int8/int4)."""
    return validate_actor_backend(actor_backend) in QUANTIZED_BACKENDS


def backend_bits(actor_backend: str) -> int:
    """Weight bit-width of a quantized actor backend (int8 -> 8, int4 -> 4)."""
    validate_actor_backend(actor_backend)
    if actor_backend not in _BACKEND_BITS:
        raise ValueError(f"actor_backend {actor_backend!r} is not a "
                         f"quantized backend {QUANTIZED_BACKENDS}")
    return _BACKEND_BITS[actor_backend]


def pack_actor_params(params: Any, bits: int = 8) -> QuantizedParams:
    """Pack an fp32 MLP, conv or sequence-policy param tree into the
    int-code deployment cache (every weight of two dims or more, dense
    ones per tensor and conv kernels per output channel; biases and norm
    gains stay fp32).

    ``bits <= 4`` stores two codes per byte along K (W4A8, half the
    cache); activations always quantize to 8 bits at run time.
    """
    if not 1 <= bits <= 8:
        raise ValueError(f"int actor cache needs 1 <= bits <= 8, "
                         f"got {bits}")
    return ptq.ptq_pack(params, QuantConfig.ptq_int(bits))


def packed_nbytes(qparams: QuantizedParams) -> int:
    """Parameter-memory footprint of the packed actor."""
    return ptq.tree_nbytes(qparams)


def calib_slice(obs: torch.Tensor, calib_batch: int) -> torch.Tensor:
    """Leading-axis slice of an observation batch for calibration."""
    return obs[:max(1, min(calib_batch, obs.shape[0]))]


def make_actor_cache(params: Any, actor_backend: str, *,
                     calib_obs: Optional[torch.Tensor] = None
                     ) -> QuantizedParams:
    """Pack (and, with ``calib_obs``, calibrate) one actor cache."""
    qparams = pack_actor_params(params, backend_bits(actor_backend))
    if calib_obs is not None:
        qparams = calibrate_actor_cache(qparams, calib_obs)
    return qparams


def _out_width(w: PackedTensor) -> int:
    return w.orig_shape[-1] if w.orig_shape is not None else w.codes.shape[-1]


def int8_dense(layer: Dict[str, Any], x: torch.Tensor, *,
               act: Optional[Callable] = None) -> torch.Tensor:
    """One dense layer through the W{8,4}A8 integer GEMM.

    ``layer`` is ``{"w": PackedTensor, "b": f32}``; ``x`` is f32 with any
    leading batch dims.  The activation is quantized per tensor to 8 bits
    from the live batch's range, the product accumulates in int32, and
    the affine dequant is the kernel's epilogue; the bias is added after.
    """
    w: PackedTensor = layer["w"]
    lead = x.shape[:-1]
    xq, xp = affine.quantize_to_int(
        x.reshape(-1, x.shape[-1]).contiguous(), 8)
    y = ops.int8_matmul(xq, w.codes, xp.delta, xp.zero_point, w.col_scale,
                        w.col_zero, w_bits=w.bits if w.bits <= 4 else 8)
    y = y + layer["b"]
    if act is not None:
        y = act(y)
    return y.reshape(lead + (_out_width(w),))


def _same_pads(size: int, k: int, stride: int):
    """TF-style "SAME" padding of one spatial axis: ``(before, after)``,
    the odd pixel after (1 each side at stride 1, k 3)."""
    total = max((-(-size // stride) - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def im2col(x: torch.Tensor, kh: int, kw: int, stride: int = 1
           ) -> torch.Tensor:
    """The "SAME" patches of NHWC ``x``: ``(B, Ho, Wo, C * kh * kw)``,
    features in ``lax.conv_general_dilated_patches``' channel-major
    ``(C, kh, kw)`` order (``F.unfold`` over the NCHW view)."""
    b = x.shape[0]
    top, bottom = _same_pads(x.shape[1], kh, stride)
    left, right = _same_pads(x.shape[2], kw, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (left, right, top, bottom))
    ho = (xp.shape[-2] - kh) // stride + 1
    wo = (xp.shape[-1] - kw) // stride + 1
    cols = F.unfold(xp, (kh, kw), stride=stride)            # (B, K, L)
    return cols.transpose(1, 2).reshape(b, ho, wo, cols.shape[1])


def int8_conv2d(layer: Dict[str, Any], x: torch.Tensor, stride: int = 1,
                act: Optional[Callable] = torch.relu) -> torch.Tensor:
    """One "SAME" conv through the W{8,4}A8 integer GEMM by im2col.

    ``layer`` is ``{"w": PackedTensor, "b": f32}`` with per-output-channel
    codes (HWIO one a byte, or int4 pre-transposed to the im2col ``(C_in *
    kh * kw, C_out)`` order and packed); ``x`` is NHWC f32.  The patch
    matrix (``im2col``) is quantized per tensor to 8 bits from its live
    range, and the product runs through ``ops.int8_matmul`` with the
    per-channel scales in the per-column epilogue.  Returns NHWC.
    """
    w: PackedTensor = layer["w"]
    kh, kw, _, c_out = w.orig_shape if w.orig_shape is not None \
        else w.codes.shape
    patches = im2col(x, kh, kw, stride)
    lead = patches.shape[:-1]
    pq, pp = affine.quantize_to_int(
        patches.reshape(-1, patches.shape[-1]), 8)
    if w.orig_shape is not None:
        w2 = w.codes
    else:
        # the patches order features (C_in, kh, kw): permute HWIO codes
        w2 = w.codes.permute(2, 0, 1, 3).reshape(-1, c_out)
    y = ops.int8_matmul(pq, w2, pp.delta, pp.zero_point, w.col_scale,
                        w.col_zero, w_bits=w.bits if w.bits <= 4 else 8)
    y = y.reshape(lead + (c_out,)) + layer["b"]
    if act is not None:
        y = act(y)
    return y


def _mlp_layer_names(n_hidden: int):
    return [f"fc{i}" for i in range(n_hidden)] + ["out"]


def _fused_layers(qparams: QuantizedParams, n_hidden: int):
    """``(QMLPLayer, ...)`` for the fused kernel from a calibrated cache."""
    act = qparams[ACT_QUANT]
    layers = []
    for i, name in enumerate(_mlp_layer_names(n_hidden)):
        w: PackedTensor = qparams[name]["w"]
        k = w.orig_shape[0] if w.orig_shape is not None else w.codes.shape[0]
        x_delta, x_zero = act[i]
        layers.append(QMLPLayer(
            codes=w.codes, col_scale=w.col_scale, col_zero=w.col_zero,
            bias=qparams[name]["b"], x_delta=x_delta, x_zero=x_zero,
            bits=w.bits, k=k))
    return tuple(layers)


def quantized_mlp_apply(qparams: QuantizedParams, x: torch.Tensor,
                        n_hidden: int) -> torch.Tensor:
    """MLP head outputs from a packed cache.

    A calibrated cache (one carrying ``ACT_QUANT``) runs the whole
    forward in one fused launch; an uncalibrated one runs the per-layer
    GEMM with dynamic activation quantization.
    """
    if ACT_QUANT in qparams:
        return ops.fused_qmlp(x, _fused_layers(qparams, n_hidden))
    for i in range(n_hidden):
        x = int8_dense(qparams[f"fc{i}"], x, act=torch.relu)
    return int8_dense(qparams["out"], x)


def quantized_cnn_apply(qparams: QuantizedParams, x: torch.Tensor,
                        n_convs: int) -> torch.Tensor:
    """Conv-net head outputs from a packed cache (always the per-layer
    path): ``x`` is NHWC f32 with any leading batch dims, flattened for
    the convs and restored on the ``(*batch, out)`` result."""
    batch_shape = x.shape[:-3]
    x = x.reshape((-1,) + tuple(x.shape[-3:]))
    for i in range(n_convs):
        x = int8_conv2d(qparams[f"conv{i}"], x)
    x = x.reshape(x.shape[0], -1)
    x = int8_dense(qparams["fc"], x, act=torch.relu)
    y = int8_dense(qparams["out"], x)
    return y.reshape(batch_shape + y.shape[-1:])


def quantized_apply(qparams: QuantizedParams, x: torch.Tensor
                    ) -> torch.Tensor:
    """Head outputs of the packed actor, dispatched on the cache's keys:
    ``embed`` selects the sequence policy (windowed form,
    ``quantized_seq_apply``), ``conv*`` the conv net, otherwise the
    MLP."""
    if "embed" in qparams:
        return quantized_seq_apply(qparams, x)
    n_convs = sum(1 for n in qparams if n.startswith("conv"))
    if n_convs:
        return quantized_cnn_apply(qparams, x, n_convs)
    n_hidden = sum(1 for n in qparams if n.startswith("fc"))
    return quantized_mlp_apply(qparams, x, n_hidden)


# ---------------------------------------------------------------------------
# Quantized sequence policy (mirror of models.seq_policy.seq_apply)
# ---------------------------------------------------------------------------

def _n_blocks(qparams: QuantizedParams) -> int:
    return sum(1 for n in qparams if n.startswith("blk"))


def quantized_seq_apply(qparams: QuantizedParams, obs: torch.Tensor
                        ) -> torch.Tensor:
    """Windowed int8 forward of the packed decoder transformer.

    The stateless mirror of ``models.seq_policy.seq_apply``: every dense
    projection runs through the W{8,4}A8 GEMM with dynamic per-tensor
    activation quantization, while rms-norms, the softmax attention and
    the residual adds stay fp32.  ``obs`` is ``(..., context, feat)``;
    the output is the head on the newest row.  Eval uses it; the rollout
    steps incrementally through ``quantized_seq_step``.
    """
    s = obs.shape[-2]
    x = int8_dense(qparams["embed"], obs)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=obs.device))
    mask = causal & valid_mask(obs)[..., None, :]
    scale = x.shape[-1] ** -0.5
    for i in range(_n_blocks(qparams)):
        blk = qparams[f"blk{i}"]
        h = mcommon.rms_norm(blk["ln1"], x)
        q = int8_dense(blk["q"], h)
        k = int8_dense(blk["k"], h)
        v = int8_dense(blk["v"], h)
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        a = torch.matmul(torch.softmax(logits, dim=-1), v)
        x = x + int8_dense(blk["o"], a)
        h2 = mcommon.rms_norm(blk["ln2"], x)
        y = int8_dense(blk["fc"], h2, act=torch.relu)
        x = x + int8_dense(blk["proj"], y)
    return int8_dense(qparams["head"], x[..., -1, :])


def seq_cache_zeros(seq_cfg, n_envs: int, size: int,
                    device=None) -> Dict[str, Any]:
    """All-zero per-env KV-cache actor state of the sequence policy.

    One int8 cache per block, slot == step index: codes ``(n_envs, size,
    d_model)`` with ``(n_envs, size, 1)`` f32 scales, plus the per-env
    int32 write counter ``count``.  ``size`` must exceed the longest
    episode (the drivers use ``max_steps + 1``).  The all-zero tree is
    also what ``rl.env.auto_reset_step`` restores when an episode ends.
    ``device=None`` is ``cuda``.
    """
    device = resolve_device(device)

    def layer():
        codes = (n_envs, size, seq_cfg.d_model)
        return {"k_codes": torch.zeros(codes, dtype=torch.int8,
                                       device=device),
                "k_scale": torch.zeros((n_envs, size, 1), device=device),
                "v_codes": torch.zeros(codes, dtype=torch.int8,
                                       device=device),
                "v_scale": torch.zeros((n_envs, size, 1), device=device)}
    return {"count": torch.zeros((n_envs,), dtype=torch.int32,
                                 device=device),
            "layers": tuple(layer() for _ in range(seq_cfg.n_layers))}


def seq_cache_nbytes(pstate: Dict[str, Any]) -> int:
    """Bytes of a KV-cache actor state (codes, scales and the counter)."""
    return sum(t.numel() * t.element_size()
               for _, t in ptq.tree_tensors(pstate))


def quantized_seq_step(qparams: QuantizedParams, feat: torch.Tensor,
                       pstate: Dict[str, Any], *, context: int):
    """One decode step of the packed transformer on the int8 KV cache.

    ``feat`` is the newest frame row ``(B, feat)``; ``pstate`` the per-env
    cache from ``seq_cache_zeros``.  Each block quantizes the new token's
    K and V with ``core.affine.quantize_symmetric``, writes them to slot
    ``count`` of each env, and attends over the last ``context`` slots
    through ``kernels.ops.int8_cache_attention``.  The write index is
    clamped to the cache as the reference's ``dynamic_update_slice``
    clamps it.  The cache is written out of place: ``pstate`` (which may
    be the reset value itself) is left as it was.  Returns ``(head_out,
    new_pstate)`` with ``count`` advanced.
    """
    count = pstate["count"]
    x = int8_dense(qparams["embed"], feat)                      # (B, D)
    layers = pstate["layers"]
    size = layers[0]["k_codes"].shape[1] if layers else 1
    rows = torch.arange(count.shape[0], device=count.device)
    slot = (rows, count.clamp(0, size - 1).to(torch.int64))
    new_layers = []
    for i in range(_n_blocks(qparams)):
        blk = qparams[f"blk{i}"]
        h = mcommon.rms_norm(blk["ln1"], x)
        q = int8_dense(blk["q"], h)
        kc, ks = affine.quantize_symmetric(int8_dense(blk["k"], h))
        vc, vs = affine.quantize_symmetric(int8_dense(blk["v"], h))
        cache = {name: layers[i][name].index_put(slot, val)
                 for name, val in (("k_codes", kc), ("k_scale", ks),
                                   ("v_codes", vc), ("v_scale", vs))}
        out = ops.int8_cache_attention(
            q[:, None, :], cache["k_codes"], cache["k_scale"],
            cache["v_codes"], cache["v_scale"], count, window=context)
        x = x + int8_dense(blk["o"], out[:, 0, :])
        h2 = mcommon.rms_norm(blk["ln2"], x)
        y = int8_dense(blk["fc"], h2, act=torch.relu)
        x = x + int8_dense(blk["proj"], y)
        new_layers.append(cache)
    head = int8_dense(qparams["head"], x)
    return head, {"count": count + 1, "layers": tuple(new_layers)}


def maybe_attach_seq_state(benv, net, actor_backend: str, n_envs: int,
                           device=None):
    """Wrap a batched env with the KV-cache actor state when it applies.

    A no-op unless ``net`` carries a ``seq_cfg`` and the actor backend is
    quantized: exactly when the rollout policy is the cached stepper
    (``quantized_seq_step``); fp32 sequence actors stay windowed.  The
    cache has ``max_steps + 1`` slots.  ``device=None`` is ``cuda``.
    """
    seq_cfg = getattr(net, "seq_cfg", None)
    if seq_cfg is None or not is_quantized(actor_backend):
        return benv
    pstate0 = seq_cache_zeros(seq_cfg, n_envs, benv.spec.max_steps + 1,
                              device)
    return attach_policy_state(benv, pstate0)


def calibrate_actor_cache(qparams: QuantizedParams, obs: torch.Tensor
                          ) -> QuantizedParams:
    """Attach static activation params to a packed MLP cache.

    Runs the per-layer dynamic path once over ``obs`` and records, per
    dense layer, the affine params the dynamic quantizer derives for that
    layer's input.  ``quantized_apply`` on the returned cache then takes
    the single-launch fused kernel.  The fused kernel is MLP-only, so a
    sequence-policy or conv cache comes back as it is (per-layer path).
    """
    if "embed" in qparams or any(n.startswith("conv") for n in qparams):
        return qparams
    n_hidden = sum(1 for n in qparams if n.startswith("fc"))
    act = []
    x = obs.reshape(-1, obs.shape[-1]).to(torch.float32)
    for i, name in enumerate(_mlp_layer_names(n_hidden)):
        p = affine.calibration_params(x, 8)
        act.append((p.delta, p.zero_point))
        if i < n_hidden:
            x = int8_dense(qparams[name], x, act=torch.relu)
    return {**qparams, ACT_QUANT: tuple(act)}


def make_act_fn(env_spec) -> Callable:
    """Deterministic deployment policy ``act(qparams, obs)``.

    Discrete envs: argmax over the first ``n_actions`` head outputs
    (int32).  Continuous envs: ``tanh(mu) * action_scale`` (f32).
    """
    if env_spec.continuous:
        def act(qparams, obs):
            """Continuous head: tanh * action_scale, f32 actions."""
            return torch.tanh(quantized_apply(qparams, obs)) \
                * env_spec.action_scale
    else:
        n_act = env_spec.n_actions

        def act(qparams, obs):
            """Discrete head: argmax over n_actions outputs, int32."""
            out = quantized_apply(qparams, obs)
            return torch.argmax(out[..., :n_act], dim=-1).to(torch.int32)
    return act


def sample_categorical(logits: torch.Tensor,
                       generator: torch.Generator) -> torch.Tensor:
    """One int32 draw per row from ``softmax(logits)`` by the Gumbel-max
    trick, as ``jax.random.categorical``: the uniforms are drawn on the
    generator's device (in ``[tiny, 1)``), the argmax on the logits'."""
    u = torch.rand(logits.shape, generator=generator,
                   device=generator.device).clamp_min(
                       torch.finfo(torch.float32).tiny).to(logits.device)
    return torch.argmax(logits - torch.log(-torch.log(u)),
                        dim=-1).to(torch.int32)


def make_sampling_policy(env_spec) -> Callable:
    """The stochastic rollout policy of the packed actor (ActorQ data
    collection for A2C): ``policy(qparams, obs, generator) -> (action,
    logits)``, an int32 action drawn from the categorical head over the
    first ``n_actions`` outputs, the logits kept as the trajectory's
    ``aux``."""
    n_act = env_spec.n_actions

    def policy(qparams, obs, generator):
        """Sample from the packed actor's categorical head."""
        logits = quantized_apply(qparams, obs)[..., :n_act]
        return sample_categorical(logits, generator), logits
    return policy
