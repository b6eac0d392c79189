"""The paper's own policy architectures (QuaRL Appendix B, Tables 5 and
10), as data.  Copied from ``repro/configs/quarl_atari.py``.

These are RL policy networks, not LM architectures: ``rl.networks``
builds them (``make_network(obs_shape, n, conv_filters=...,
fc_width=...)`` or ``hidden=widths``).

  Atari DQN backbone: 3 conv x 128 + FC 128 (Appendix B).
  Policy A: 3 conv x 128 + FC 128     (Table 10)
  Policy B: 3 conv x 512 + FC 512
  Policy C: 3 conv x 1024 + FC 2048
  Deployment policies (Table 5): 3-layer MLPs 64 / 256 / (4096, 512, 1024).
"""
import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ConvPolicyConfig:
    """A conv policy: its 3x3 conv widths and the FC width after them."""

    name: str
    conv_filters: Tuple[int, ...]
    fc_width: int


@dataclasses.dataclass(frozen=True)
class MLPPolicyConfig:
    """A deployment MLP policy: its hidden widths."""

    name: str
    widths: Tuple[int, ...]


ATARI_DQN = ConvPolicyConfig("atari_dqn", (128, 128, 128), 128)
POLICY_A = ConvPolicyConfig("policy_a", (128, 128, 128), 128)
POLICY_B = ConvPolicyConfig("policy_b", (512, 512, 512), 512)
POLICY_C = ConvPolicyConfig("policy_c", (1024, 1024, 1024), 2048)

DEPLOY_POLICY_I = MLPPolicyConfig("policy_i", (64, 64, 64))
DEPLOY_POLICY_II = MLPPolicyConfig("policy_ii", (256, 256, 256))
DEPLOY_POLICY_III = MLPPolicyConfig("policy_iii", (4096, 512, 1024))
