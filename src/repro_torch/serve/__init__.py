"""Continuous-batching serving runtime of the port."""
