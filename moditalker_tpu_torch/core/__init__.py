"""Diffusion schedules and samplers."""
