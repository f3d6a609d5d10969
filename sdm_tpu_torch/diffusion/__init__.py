"""Reverse-process samplers."""
