"""Serving steps of the dense LM: prefill and one-token decode."""
