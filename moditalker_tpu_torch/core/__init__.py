"""Diffusion schedules and samplers; the trainers' optimizer, EMA,
learning-rate schedules, checkpoints, preemption latch and metric log."""
