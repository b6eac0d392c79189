"""Batched torch environments of the port: AirNav, CartPole, Catch,
MountainCar (discrete and continuous), Pendulum and the partially
observed / frame-stacked wrappers of the sequence policy."""
from repro_torch.rl.envs.airnav import make_airnav
from repro_torch.rl.envs.cartpole import make_cartpole
from repro_torch.rl.envs.catch import make_catch
from repro_torch.rl.envs.mountaincar import (
    make_mountaincar,
    make_mountaincar_continuous,
)
from repro_torch.rl.envs.pendulum import make_pendulum
from repro_torch.rl.envs.wrappers import (
    make_airnav_seq,
    make_catch_seq,
    make_flicker_airnav,
    make_framestack,
    make_masked_catch,
)

ENVS = {
    "airnav": make_airnav,
    "cartpole": make_cartpole,
    "mountaincar": make_mountaincar,
    "mountaincar_continuous": make_mountaincar_continuous,
    "pendulum": make_pendulum,
    "catch": make_catch,
    "catch_masked": make_masked_catch,
    "airnav_flicker": make_flicker_airnav,
    "catch_seq": make_catch_seq,
    "airnav_seq": make_airnav_seq,
}

__all__ = ["ENVS", "make", "make_airnav", "make_cartpole", "make_catch",
           "make_mountaincar", "make_mountaincar_continuous",
           "make_pendulum", "make_masked_catch", "make_flicker_airnav",
           "make_framestack", "make_catch_seq", "make_airnav_seq"]


def make(name: str, **kwargs):
    """Build a registered env by name."""
    if name not in ENVS:
        raise KeyError(f"unknown env {name!r}; registered: "
                       f"{sorted(ENVS)}")
    return ENVS[name](**kwargs)
