"""Scheduler wire protocol and client runtime (pure Python)."""
