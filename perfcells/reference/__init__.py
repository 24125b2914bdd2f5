"""Plain references that decide ``correct``: numpy and plain PyTorch.

They import nothing of the port, of the JAX package, or of ``jax``, and
take nothing the program made: each works its answer out again from the
inputs the benchmark generated, and reads the program's outputs only to
judge them.
"""
