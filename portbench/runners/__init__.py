"""One runner per kind of configuration (its ``runner`` field)."""
