"""Plain references the benchmark holds the port to."""
