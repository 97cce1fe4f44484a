"""Executors that drive the device operators."""
