"""parallel layer of the PyTorch/CUDA port: the row-sharded mesh and its
collectives, and the multi-process mesh (dp over processes)."""
