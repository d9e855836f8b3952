"""Device operations: the segment oracle, the tiled chunk layout and
the chunk_partials kernel (with its plain PyTorch version)."""
