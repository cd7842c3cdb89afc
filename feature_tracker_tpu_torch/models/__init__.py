"""Neural models of the port (inference)."""
