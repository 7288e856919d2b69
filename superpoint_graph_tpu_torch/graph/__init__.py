"""Superpoint-graph construction (host)."""
