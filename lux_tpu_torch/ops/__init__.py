"""Device operations: the segment oracle, the tiled chunk layout, the
paged gather and its row classes, and the hand-written kernels with
their plain PyTorch versions (chunk_partials, lane_shuffle)."""
