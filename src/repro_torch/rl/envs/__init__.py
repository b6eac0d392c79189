"""Batched torch environments of the port (AirNav so far)."""
from repro_torch.rl.envs.airnav import make_airnav

ENVS = {"airnav": make_airnav}

__all__ = ["ENVS", "make", "make_airnav"]


def make(name: str, **kwargs):
    """Build a registered env by name."""
    if name not in ENVS:
        raise KeyError(f"env {name!r} is not ported yet; ported: "
                       f"{sorted(ENVS)}")
    return ENVS[name](**kwargs)
