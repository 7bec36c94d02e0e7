"""Layers of the ported slices: attention, stacked blocks, greedy search,
embedding and layer norm."""
