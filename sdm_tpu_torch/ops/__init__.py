"""Tensor ops: noise schedules and GroupNorm."""
