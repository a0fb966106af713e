"""PyTorch/CUDA port of the ODIN serving system (the JAX package ``repro`` is
its reference).  See README.md, "PyTorch/H100 port"."""
