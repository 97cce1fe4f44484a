"""Workload generators."""
