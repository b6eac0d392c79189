"""Optimizers of the port (the fp32 Adam of the RL learner so far)."""
