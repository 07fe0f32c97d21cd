"""ram layer of the PyTorch/CUDA port."""
