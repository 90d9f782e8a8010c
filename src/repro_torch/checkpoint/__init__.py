"""Atomic, asynchronous, retention-pruned checkpoints."""
