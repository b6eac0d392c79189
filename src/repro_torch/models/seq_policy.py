"""Small decoder-transformer policy for partially observed RL.

Counterpart of ``repro/models/seq_policy.py``: a pre-norm decoder
transformer sized for RL actors (single-head attention, a few thousand
params) whose weights pack through ``core.ptq`` like the MLP actor's, and
whose decode path runs on the int8 KV cache (``rl.actorq.
quantized_seq_step``, kernel B3 on the card).

Observation contract (``rl.envs.wrappers.make_framestack``): ``obs`` is
``(..., context, feat)``, a causal window of per-step rows, oldest first.
Each row is ``[inner_obs..., t / max_steps, valid]``; ``valid`` masks the
all-zero rows that predate the episode, and the in-row time feature is
the only positional signal, so the windowed form here and the
incremental cached form attend over the same tokens.

Every dense layer is a QAT site pair, as in the reference: its weight
goes through ``ctx.weight("<name>/w", ...)`` and its output through
``ctx.activation("<name>/out", ...)`` of a ``core.fake_quant`` context,
the names being ``embed``, ``blk{i}/{q,k,v,o,fc,proj}`` and ``head``
(4 + 12 * ``n_layers`` sites a forward, each one launch of kernel B5's
site kernel on the card).  Without a context (``ctx=None``) it is the
``NullQATContext``, which passes both through, so the fp32 forward is
unchanged.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch.core.fake_quant import NullQATContext
from repro_torch.models import common
from repro_torch.models.common import P

NEG_INF = -1e30


class SeqPolicyConfig(NamedTuple):
    """Static shape record carried on ``rl.networks.Network.seq_cfg``.

    ``context``/``feat_dim`` mirror the env's ``obs_shape = (context,
    feat_dim)``; ``n_layers`` and ``d_model`` size the per-env KV cache
    (``rl.actorq.seq_cache_zeros``).
    """

    context: int
    feat_dim: int
    d_model: int
    n_layers: int
    d_ff: int
    out_dim: int


def _dense_spec(d_in: int, d_out: int, scale=None) -> Dict[str, P]:
    return {"w": P((d_in, d_out), scale=scale), "b": P((d_out,), "zeros")}


def _dense(ctx, name, params, x, act=None):
    y = x @ ctx.weight(f"{name}/w", params["w"]) + params["b"]
    if act is not None:
        y = act(y)
    return ctx.activation(f"{name}/out", y)


def seq_spec(cfg: SeqPolicyConfig) -> Dict[str, Any]:
    """Parameter spec tree: ``embed``, ``blk{i}`` (ln1, q, k, v, o, ln2,
    fc, proj) and ``head``, as in the reference.

    ``"embed"`` marks a sequence policy (``actorq.quantized_apply``
    dispatches on it).  Every 2-D weight packs to int codes; biases and
    norm gains stay fp32.
    """
    d, f = cfg.d_model, cfg.d_ff
    spec: Dict[str, Any] = {"embed": _dense_spec(cfg.feat_dim, d)}
    for i in range(cfg.n_layers):
        spec[f"blk{i}"] = {
            "ln1": common.rms_norm_spec(d),
            "q": _dense_spec(d, d),
            "k": _dense_spec(d, d),
            "v": _dense_spec(d, d),
            "o": _dense_spec(d, d),
            "ln2": common.rms_norm_spec(d),
            "fc": _dense_spec(d, f),
            "proj": _dense_spec(f, d),
        }
    spec["head"] = _dense_spec(d, cfg.out_dim, scale=0.01)
    return spec


def valid_mask(obs: torch.Tensor) -> torch.Tensor:
    """``(..., S)`` row-validity mask from the trailing valid flag."""
    return obs[..., -1] > 0.5


def seq_apply(params, obs: torch.Tensor, cfg: SeqPolicyConfig,
              ctx=None) -> torch.Tensor:
    """Windowed fp32 forward: ``obs (..., context, feat) -> (..., out)``.

    Causal single-head self-attention over the frame rows with the
    pre-episode rows masked out of the keys; the head reads the newest
    row.  Any leading batch dims.  ``ctx`` is a ``core.fake_quant``
    context (``None``: full precision).
    """
    ctx = NullQATContext() if ctx is None else ctx
    s = obs.shape[-2]
    x = _dense(ctx, "embed", params["embed"], obs)         # (..., S, D)
    causal = torch.tril(torch.ones((s, s), dtype=torch.bool,
                                   device=obs.device))
    mask = causal & valid_mask(obs)[..., None, :]          # (..., S, S)
    scale = cfg.d_model ** -0.5
    for i in range(cfg.n_layers):
        blk = params[f"blk{i}"]
        h = common.rms_norm(blk["ln1"], x)
        q = _dense(ctx, f"blk{i}/q", blk["q"], h)
        k = _dense(ctx, f"blk{i}/k", blk["k"], h)
        v = _dense(ctx, f"blk{i}/v", blk["v"], h)
        logits = torch.matmul(q, k.transpose(-1, -2)) * scale
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
        a = torch.matmul(torch.softmax(logits, dim=-1), v)
        x = x + _dense(ctx, f"blk{i}/o", blk["o"], a)
        h2 = common.rms_norm(blk["ln2"], x)
        y = _dense(ctx, f"blk{i}/fc", blk["fc"], h2, act=torch.relu)
        x = x + _dense(ctx, f"blk{i}/proj", blk["proj"], y)
    return _dense(ctx, "head", params["head"], x[..., -1, :])


def make_seq_policy(obs_shape: Tuple[int, int], out_dim: int, *,
                    d_model: int = 32, n_layers: int = 2, d_ff: int = 64
                    ) -> Tuple[Dict[str, Any], Callable, SeqPolicyConfig]:
    """``(spec, apply(params, obs, ctx=None), cfg)`` for a frame-stacked
    env's ``(S, F)`` observations; ``obs_shape`` of another rank raises
    ``ValueError``."""
    if len(obs_shape) != 2:
        raise ValueError("sequence policies need obs_shape (context, "
                         f"feat), got {obs_shape}")
    cfg = SeqPolicyConfig(context=int(obs_shape[0]),
                          feat_dim=int(obs_shape[1]), d_model=d_model,
                          n_layers=n_layers, d_ff=d_ff, out_dim=out_dim)

    def apply_fn(params, obs, ctx=None):
        """Windowed fp32 forward of this config under ``ctx``."""
        return seq_apply(params, obs, cfg, ctx)

    return seq_spec(cfg), apply_fn, cfg
