"""Serving steps of the LM side (the training step is not ported yet)."""
