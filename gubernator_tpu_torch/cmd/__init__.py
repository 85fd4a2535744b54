"""Entry-point binaries: ``python -m gubernator_tpu_torch`` runs the server
daemon (cmd/server.py). The load generator, the local cluster and the
health probe of the JAX package's cmd/ wait for a later slice."""
