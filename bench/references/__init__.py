"""Plain references of the benchmark's configurations."""
