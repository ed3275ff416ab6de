"""Sampling pipelines."""
