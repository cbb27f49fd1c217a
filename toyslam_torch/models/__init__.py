"""Factor-graph data structures (tensors)."""
