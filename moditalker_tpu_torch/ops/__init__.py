"""Attention primitives, rotary embeddings and the hand-written kernels."""
