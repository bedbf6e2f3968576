"""Examples that run on the port: twins of the repository's ``examples/``."""
