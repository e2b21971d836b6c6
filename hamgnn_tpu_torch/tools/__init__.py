"""Console tools of the port."""
