"""The benchmark's plain reference: NumPy and plain PyTorch only."""
