"""Companion rule passes sharing the egress framework's Finding plumbing."""
from . import asserts, determinism, locks  # noqa: F401

__all__ = ["asserts", "determinism", "locks"]
