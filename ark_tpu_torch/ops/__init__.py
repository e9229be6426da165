"""Device ops of the port: torch ops, plus hand-written CUDA kernels where the
JAX package has a Pallas kernel. Imports only torch, numpy and the stdlib."""
