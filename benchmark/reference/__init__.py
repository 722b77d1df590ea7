"""The plain reference that decides ``correct``: plain Python and NumPy,
working from the benchmark's own strings. It imports nothing of the
program, of ``jax`` or of the JAX package, and takes nothing the program
made."""
