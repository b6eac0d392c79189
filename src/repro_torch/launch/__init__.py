"""Launchers of the port: the trainer and the server, the host mesh
and the analytic step model."""
