"""Plain references of the configurations."""
