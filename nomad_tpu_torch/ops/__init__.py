"""Device-side ops: the placement kernels and their build."""
