"""Integrity and structural guards for published actor caches."""
