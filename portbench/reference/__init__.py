"""Plain PyTorch reference of the benchmark's models and training step."""
