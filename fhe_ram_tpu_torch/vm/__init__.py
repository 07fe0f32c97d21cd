"""vm layer of the PyTorch/CUDA port: the encrypted VM instruction cycle
(ALU, store-width selection, pointer-to-address conversion, the RAM
fetch and store)."""
