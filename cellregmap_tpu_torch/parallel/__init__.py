"""Durable checkpoints of the port's scans (host side)."""
