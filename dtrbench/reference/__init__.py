"""Plain references of the benchmark's model families, one file each."""
