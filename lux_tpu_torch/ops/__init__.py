"""Device operations: the segment oracle, the tiled chunk layout and its
streamed forms, the owner exchange's layout, the paged gather and its
row classes, and the hand-written kernels with
their plain PyTorch versions (chunk_partials, lane_shuffle, and the
probe kernels carry_combine, fused_carry, onehot_reduce,
transposed_reduce, sub_gather, elementwise, block_rowsum)."""
