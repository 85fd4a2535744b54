"""Plain NumPy reference of the rate limiter's semantics.

Nothing here imports the port, JAX or the JAX package: the key hash, the
response decoder, the seeded table and the judge of every answer are worked
out again from the inputs the harness made.
"""
