"""Checkpoints, bundles and the flax-to-torch parameter bridge."""
