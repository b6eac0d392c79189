"""Launchers of the port (the ``--mode rl`` trainer so far)."""
