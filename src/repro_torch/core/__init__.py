"""FreshDiskANN core in PyTorch: config, distances, PQ, graphs, beam search,
RobustPrune, batched insert, the in-memory index, the LTI and the system."""
