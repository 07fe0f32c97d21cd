"""parallel layer of the PyTorch/CUDA port: the row-sharded mesh and its
collectives."""
