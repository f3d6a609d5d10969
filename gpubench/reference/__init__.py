"""The benchmark's plain float32 reference (no code of the program)."""
