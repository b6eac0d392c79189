"""Optimizers of the port: Adam (float32 or 8-bit moments), SGD and the
lr schedules."""
