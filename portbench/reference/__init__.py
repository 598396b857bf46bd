"""Plain NumPy reference of the scheduler's semantics.

Imports neither ``jax``, nor the JAX package, nor anything of the port: it
works every verdict, score and placement out again from the inputs the
benchmark generated (annotation values and timestamps, allocatable, pod
requests, the policy in the configuration's file).
"""
