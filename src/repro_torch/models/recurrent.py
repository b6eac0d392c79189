"""Recurrent blocks: RG-LRU (RecurrentGemma / Griffin) and xLSTM (mLSTM,
sLSTM).

Counterpart of ``repro/models/recurrent.py`` for inference (prefill and
decode):

* The RG-LRU's prefill is the linear recurrence ``h_t = a_t * h_{t-1} +
  b_t``, which the reference runs as ``jax.lax.associative_scan``.
  ``linear_scan`` is that scan in torch, step for step (pairs combined,
  the half-length scan recursed, the even elements filled in): log-depth,
  about 15 launches a level, so a prefill of S tokens costs about
  ``15 * 2 * log2(S)`` launches a layer and not S.  Decode is one step of
  the recurrence.
* mLSTM and sLSTM are nonlinear, exponentially gated recurrences; like
  the reference's ``lax.scan``, they loop over time.  The reference's
  ``scan_chunked`` only changes what its backward stores, so the port's
  forward loops over every step.
* Recurrent state stays float32, as in the reference.

Decode state of these layers:
  rglru: {"h": (B, D), "conv": (B, W-1, D)}
  mlstm: {"c": (B, H, Dh, Dh), "n": (B, H, Dh), "m": (B, H)}
  slstm: {"c": (B, H, Dh), "n": (B, H), "m": (B, H)}

Numerics mirror the reference's: ``jax.nn.softplus`` is ``logaddexp(x,
0)`` (``torch.logaddexp``, where ``F.softplus`` would switch to ``x``
above 20), ``jax.nn.gelu`` is the tanh approximation, the ``1e-9``
floor of the RG-LRU's input scale and the mLSTM's ``max(|n.q|,
exp(-m))`` denominator are kept.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch._subclasses.fake_tensor import FakeTensor

from repro_torch.models import common
from repro_torch.models.common import P, dense_spec

CONV_WIDTH = 4
_C = 8.0  # griffin's recurrence sharpness constant

State = Dict[str, torch.Tensor]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


# ---------------------------------------------------------------------------
# depthwise causal temporal conv (griffin's conv1d, width 4)
# ---------------------------------------------------------------------------

def conv1d_spec(channels: int) -> Dict[str, P]:
    """A ``(W, C)`` depthwise kernel (scale 0.5) and a zero bias."""
    return {"w": P((CONV_WIDTH, channels), scale=0.5, axes=(None, "mlp")),
            "b": P((channels,), init="zeros", axes=("mlp",))}


def causal_conv1d(params, x: torch.Tensor,
                  state: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``x (B, S, C)`` -> ``(out (B, S, C), new_state)``; ``state (B, W-1,
    C)`` holds the previous inputs in decode (zeros before the first).
    Without a state the new one is None when ``S < W - 1``, as in the
    reference."""
    w = params["w"].to(x.dtype)          # (W, C)
    width = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], width - 1, x.shape[2]),
                          dtype=x.dtype, device=x.device)
        xp = torch.cat([pad, x], dim=1)
        new_state = None if x.shape[1] < width - 1 \
            else xp[:, -(width - 1):]
    else:
        xp = torch.cat([state.to(x.dtype), x], dim=1)
        new_state = xp[:, -(width - 1):]
    s = x.shape[1]
    out = sum(xp[:, i:i + s] * w[i] for i in range(width))
    return out + params["b"].to(x.dtype), new_state


# ---------------------------------------------------------------------------
# RG-LRU (Real-Gated Linear Recurrent Unit) -- arXiv:2402.19427
# ---------------------------------------------------------------------------

def rglru_spec(d_model: int) -> Dict[str, Any]:
    """The block's projections, conv, gates and ``log_lambda`` (the LRU
    width is ``d_model``, as in recurrentgemma-2b)."""
    dr = d_model
    return {
        "wx": dense_spec(d_model, dr, "embed", "mlp"),
        "wg": dense_spec(d_model, dr, "embed", "mlp"),
        "conv": conv1d_spec(dr),
        "gate_a": dense_spec(dr, dr, "mlp", None),
        "gate_x": dense_spec(dr, dr, "mlp", None),
        "log_lambda": P((dr,), init="normal", scale=0.5, axes=("mlp",)),
        "wo": dense_spec(dr, d_model, "mlp", "embed"),
    }


def _rglru_coeffs(ctx, params, x: torch.Tensor, name: str
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-step ``(a, b)`` of the recurrence ``h = a * h + b``, float32."""
    r = torch.sigmoid(common.dense(ctx, f"{name}/gate_a", params["gate_a"],
                                   x, quant_act=False).to(torch.float32))
    i = torch.sigmoid(common.dense(ctx, f"{name}/gate_x", params["gate_x"],
                                   x, quant_act=False).to(torch.float32))
    log_a = -_C * _softplus(params["log_lambda"].to(torch.float32)) * r
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-9)) \
        * (i * x.to(torch.float32))
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive scan of ``(a, b)`` over axis 1 under ``(a1, b1) o (a2,
    b2) = (a1 * a2, a2 * b1 + b2)``: the second output is ``h_t = a_t *
    h_{t-1} + b_t`` from ``h = 0``.

    ``jax.lax.associative_scan``'s algorithm, in its order of operations:
    combine adjacent pairs, scan the half-length sequence, then combine
    each even element with the odd prefix before it.
    """
    n = a.shape[1]
    if n < 2:
        return a, b
    a_e, a_o = a[:, 0:-1:2], a[:, 1::2]
    b_e, b_o = b[:, 0:-1:2], b[:, 1::2]
    odd_a, odd_b = linear_scan(a_e * a_o, a_o * b_e + b_o)
    a_2, b_2 = a[:, 2::2], b[:, 2::2]
    if n % 2 == 0:
        odd_a_l, odd_b_l = odd_a[:, :-1], odd_b[:, :-1]
    else:
        odd_a_l, odd_b_l = odd_a, odd_b
    even_a = torch.cat([a[:, :1], odd_a_l * a_2], dim=1)
    even_b = torch.cat([b[:, :1], a_2 * odd_b_l + b_2], dim=1)
    out_a, out_b = torch.empty_like(a), torch.empty_like(b)
    out_a[:, 0::2], out_a[:, 1::2] = even_a, odd_a
    out_b[:, 0::2], out_b[:, 1::2] = even_b, odd_b
    return out_a, out_b


def rglru_block(ctx, params, x: torch.Tensor,
                state: Optional[State] = None, name: str = "rglru"
                ) -> Tuple[torch.Tensor, Optional[State]]:
    """Griffin's recurrent block: ``Wo(gelu(Wg x) * RGLRU(conv1d(Wx
    x)))``.  Prefill (``state`` None) scans the sequence; decode steps
    from ``state``.  Returns the output and the new state (its ``conv``
    None after a prefill of fewer than ``W - 1`` tokens)."""
    gate = F.gelu(common.dense(ctx, f"{name}/wg", params["wg"], x),
                  approximate="tanh")
    xr = common.dense(ctx, f"{name}/wx", params["wx"], x, quant_act=False)
    xr, conv_state = causal_conv1d(params["conv"], xr,
                                   None if state is None else state["conv"])
    xr = ctx.activation(f"{name}/conv_out", xr)
    a, b = _rglru_coeffs(ctx, params, xr, name)
    if state is None:
        _, h = linear_scan(a, b)     # h_0 = 0: h_t is the scanned b
        new_state = None if x.shape[1] == 0 else {"h": h[:, -1],
                                                  "conv": conv_state}
    else:
        h = a * state["h"][:, None].to(torch.float32) + b
        new_state = {"h": h[:, -1], "conv": conv_state}
    h = ctx.activation(f"{name}/h", h.to(x.dtype))
    out = common.dense(ctx, f"{name}/wo", params["wo"], h * gate)
    return out, new_state


# ---------------------------------------------------------------------------
# xLSTM -- arXiv:2405.04517
# ---------------------------------------------------------------------------

def mlstm_spec(d_model: int, n_heads: int, head_dim: int) -> Dict[str, Any]:
    """q, k, v, the scalar input and forget gates (with biases), the
    output gate and the out projection."""
    d_inner = n_heads * head_dim
    return {
        "wq": dense_spec(d_model, d_inner, "embed", "heads"),
        "wk": dense_spec(d_model, d_inner, "embed", "heads"),
        "wv": dense_spec(d_model, d_inner, "embed", "heads"),
        "wi": dense_spec(d_model, n_heads, "embed", None, bias=True),
        "wf": dense_spec(d_model, n_heads, "embed", None, bias=True),
        "wg": dense_spec(d_model, d_inner, "embed", "heads"),
        "wo": dense_spec(d_inner, d_model, "heads", "embed"),
    }


def _scan(fn, *args):
    """``fn(*args) -> (h, c, n, m)``, a block's loop over the steps of
    ``args[0]`` (``(B, S, ...)``).  On DTensors a loop of more than one
    step runs on each rank's batch shard (``common.batch_local``: no
    DTensor dispatch per op); one step (decode) keeps DTensor's own
    layout, its state split as the reference's caches are."""
    if args[0].shape[1] > 1:
        return common.batch_local(fn, 4, *args)
    return fn(*args)


def time_loop(step, carry: Tuple[torch.Tensor, ...],
              xs: Tuple[torch.Tensor, ...]) -> Tuple[torch.Tensor, ...]:
    """``step(*carry, *x_t) -> (*carry, h_t)`` over the time steps of
    ``xs`` (each ``(B, S, ...)``): ``(h (B, S, ...), *carry)``.

    In the pod dry-run's trace (``FakeTensor`` inputs) one step is traced
    and counted as ``S`` (``_TracedLoop``), as the reference's analysis
    weights its scan's body by its trip count: 4,096 steps cost one
    step's dispatch.
    """
    s = xs[0].shape[1]
    if isinstance(xs[0], FakeTensor) and s > 1:
        return _TracedLoop.apply(step, len(carry), *carry, *xs)
    hs = []
    for t in range(s):
        *carry, h = step(*carry, *(x[:, t] for x in xs))
        hs.append(h)
    return (torch.stack(hs, dim=1), *carry)


class _TracedLoop(torch.autograd.Function):
    """``time_loop`` over fake tensors: the forward runs step 0 counted
    ``S`` times and holds, for the backward, ``S`` times the bytes that
    step saves for it (the loop's saved activations); the backward counts
    step 0's gradient ``S`` times (its recomputation not at all).  The
    outputs are empty tensors of the loop's shapes."""

    @staticmethod
    def forward(ctx, step, n_carry, *args):
        from repro_torch.launch import trace_analysis as ta
        s = args[n_carry].shape[1]
        need = ctx.needs_input_grad[2:]
        xs = {a.untyped_storage()._cdata for a in args[n_carry:]}
        saved = {}

        def pack(t):        # what a step keeps (its slices of xs aside)
            st = t.untyped_storage()
            if st._cdata not in xs:
                saved[st._cdata] = st.nbytes()
            return t
        with torch.enable_grad(), ta.repeated(s), \
                torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            *carry, h = step(*_step_inputs(args, n_carry, need))
        hold = h.new_empty((s * sum(saved.values()),), dtype=torch.uint8) \
            if any(need) else None
        ctx.step, ctx.n_carry = step, n_carry
        ctx.save_for_backward(*args, hold)
        return (h.new_empty((h.shape[0], s) + tuple(h.shape[1:])),
                *(c.detach() for c in carry))

    @staticmethod
    def backward(ctx, gh, *gcarry):
        from repro_torch.launch import trace_analysis as ta
        args = ctx.saved_tensors[:-1]
        n_carry, s = ctx.n_carry, args[ctx.n_carry].shape[1]
        need = ctx.needs_input_grad[2:]
        with torch.enable_grad():
            inputs = _step_inputs(args, n_carry, need)
            with ta.repeated(0):
                outs = ctx.step(*inputs)
            pairs = [(o, g) for o, g in zip(outs, (*gcarry, gh[:, 0]))
                     if g is not None and o.requires_grad]
            wrt = [x for x, nd in zip(inputs, need) if nd]
            with ta.repeated(s):
                grads = iter(torch.autograd.grad(
                    [o for o, _ in pairs], wrt, [g for _, g in pairs],
                    allow_unused=True))
        out = []
        for i, (a, nd) in enumerate(zip(args, need)):
            g = next(grads) if nd else None
            if nd and i >= n_carry:     # a step's slice -> the whole
                g = a.new_empty(a.shape)
            out.append(g)
        return (None, None, *out)


def _step_inputs(args, n_carry, need):
    """Step 0's inputs out of ``_TracedLoop``'s arguments, detached, each
    asking for its gradient where ``need`` says."""
    return [(a if i < n_carry else a[:, 0]).detach().requires_grad_(nd)
            for i, (a, nd) in enumerate(zip(args, need))]


def _mlstm_step(c, n, m, q, k, v, i_pre, log_f):
    """The stabilised mLSTM recurrence (the paper's eq. 19-27), one step;
    ``log_f`` is ``log sigmoid(f_pre)``, computed for all steps before."""
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = (f_g[..., None, None] * c
             + i_g[..., None, None] * v[..., :, None] * k[..., None, :])
    n_new = f_g[..., None] * n + i_g[..., None] * k
    denom = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", n_new, q)),
                          torch.exp(-m_new))
    h = torch.einsum("bhde,bhe->bhd", c_new, q) / denom[..., None]
    return c_new, n_new, m_new, h


def _mlstm_scan(q, k, v, i_pre, log_f, c, n, m):
    """The recurrence over the sequence from ``(c, n, m)`` (zeros where
    None): ``(h (B, S, H, Dh), c, n, m)`` after the last step."""
    if c is None:
        b, _, nh, hd = q.shape
        c, n, m = (q.new_zeros((b, nh, hd, hd)), q.new_zeros((b, nh, hd)),
                   q.new_zeros((b, nh)))
    return time_loop(_mlstm_step, (c, n, m), (q, k, v, i_pre, log_f))


def mlstm_block(ctx, params, x: torch.Tensor, *, n_heads: int,
                head_dim: int, state: Optional[State] = None,
                name: str = "mlstm") -> Tuple[torch.Tensor, State]:
    """The mLSTM block over ``x (B, S, D)``, from ``state`` or zeros;
    returns the output and the state after the last step."""
    b, s, _ = x.shape

    def to_heads(t):
        return common.reshape(t, b, s, n_heads, head_dim).to(torch.float32)
    q = to_heads(common.dense(ctx, f"{name}/wq", params["wq"], x)) \
        * head_dim ** -0.5
    k = to_heads(common.dense(ctx, f"{name}/wk", params["wk"], x)) \
        * head_dim ** -0.5
    v = to_heads(common.dense(ctx, f"{name}/wv", params["wv"], x))
    i_pre = common.dense(ctx, f"{name}/wi", params["wi"], x,
                         quant_act=False).to(torch.float32)
    f_pre = common.dense(ctx, f"{name}/wf", params["wf"], x,
                         quant_act=False).to(torch.float32)
    log_f = -_softplus(-f_pre)

    h, c, n, m = _scan(
        _mlstm_scan, q, k, v, i_pre, log_f,
        *((None,) * 3 if state is None
          else (state["c"], state["n"], state["m"])))

    gate = F.silu(common.dense(ctx, f"{name}/wg", params["wg"], x))
    h = ctx.activation(f"{name}/h", common.reshape(h, b, s, n_heads * head_dim)
                       .to(x.dtype))
    out = common.dense(ctx, f"{name}/wo", params["wo"], h * gate)
    return out, {"c": c, "n": n, "m": m}


def slstm_spec(d_model: int, n_heads: int, head_dim: int) -> Dict[str, Any]:
    """The cell input, the scalar gates (with biases), the output gate and
    the out projection."""
    d_inner = n_heads * head_dim
    return {
        "wz": dense_spec(d_model, d_inner, "embed", "heads"),
        "wi": dense_spec(d_model, n_heads, "embed", None, bias=True),
        "wf": dense_spec(d_model, n_heads, "embed", None, bias=True),
        "wo_gate": dense_spec(d_model, d_inner, "embed", "heads"),
        "wo": dense_spec(d_inner, d_model, "heads", "embed"),
    }


def _slstm_step(c, n, m, tz, i_pre, log_f):
    """One sLSTM step; ``tz`` is ``tanh(z)``, ``log_f`` ``log
    sigmoid(f_pre)``, both computed for all steps before."""
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c_new = f_g[..., None] * c + i_g[..., None] * tz
    n_new = f_g * n + i_g
    h = c_new / torch.clamp(n_new, min=1.0)[..., None]
    return c_new, n_new, m_new, h


def _slstm_scan(tz, i_pre, log_f, c, n, m):
    """The recurrence over the sequence from ``(c, n, m)`` (zeros where
    None): ``(h (B, S, H, Dh), c, n, m)`` after the last step."""
    if c is None:
        b, _, nh, hd = tz.shape
        c, n, m = (tz.new_zeros((b, nh, hd)), tz.new_zeros((b, nh)),
                   tz.new_zeros((b, nh)))
    return time_loop(_slstm_step, (c, n, m), (tz, i_pre, log_f))


def slstm_block(ctx, params, x: torch.Tensor, *, n_heads: int,
                head_dim: int, state: Optional[State] = None,
                name: str = "slstm") -> Tuple[torch.Tensor, State]:
    """The sLSTM block over ``x (B, S, D)``, from ``state`` or zeros;
    returns the output and the state after the last step."""
    b, s, _ = x.shape
    z = common.reshape(common.dense(ctx, f"{name}/wz", params["wz"], x),
                       b, s, n_heads, head_dim).to(torch.float32)
    i_pre = common.dense(ctx, f"{name}/wi", params["wi"], x,
                         quant_act=False).to(torch.float32)
    f_pre = common.dense(ctx, f"{name}/wf", params["wf"], x,
                         quant_act=False).to(torch.float32)
    tz, log_f = torch.tanh(z), -_softplus(-f_pre)

    h, c, n, m = _scan(
        _slstm_scan, tz, i_pre, log_f,
        *((None,) * 3 if state is None
          else (state["c"], state["n"], state["m"])))

    gate = F.silu(common.dense(ctx, f"{name}/wo_gate", params["wo_gate"],
                               x))
    h = ctx.activation(f"{name}/h", common.reshape(h, b, s, n_heads * head_dim)
                       .to(x.dtype))
    out = common.dense(ctx, f"{name}/wo", params["wo"], h * gate)
    return out, {"c": c, "n": n, "m": m}
