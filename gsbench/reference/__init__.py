"""Plain references of the port's work, in NumPy and PyTorch operations.

Nothing here imports the port, JAX or the JAX package: each module follows
the published semantics of what it checks, with its own code.
"""
