"""PyTorch/CUDA port of the ring RPQ engine: the JAX package's host
modules copied beside hand-written CUDA kernels for Hopper."""
__version__ = "0.1.0"
