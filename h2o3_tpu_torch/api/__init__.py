"""The algorithm registry of the port (``registry.algo_map``). The REST
surface of the JAX package's ``api/`` is not part of this package yet."""
