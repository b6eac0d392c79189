"""Continuous-batching quantized policy serving on the card.

Sessions are multiplexed onto shape-bucketed padded batches (``batcher``)
answered by a packed fp32/int8/int4 actor cache with a never-torn
hot-swap on every param push (``server``), with per-session accounting
(``session``).
"""
from repro_torch.device import resolve_device
from repro_torch.serving.batcher import (Batcher, DeadlineExceededError,
                                         QueueFullError, Request,
                                         ServeResult, pad_rows,
                                         remove_padding, select_bucket)
from repro_torch.serving.server import (CacheEntry, PolicyServer,
                                        WorkerCrashError, greedy_calib_obs,
                                        make_fp32_act_fn)
from repro_torch.serving.session import Session, SessionTable, StepCounter

__all__ = [
    "Batcher", "DeadlineExceededError", "QueueFullError", "Request",
    "ServeResult", "pad_rows", "remove_padding", "select_bucket",
    "CacheEntry", "PolicyServer", "WorkerCrashError", "greedy_calib_obs",
    "make_fp32_act_fn", "resolve_device", "Session", "SessionTable",
    "StepCounter",
]
