"""Layers of the decode slice: attention, stacked blocks, greedy search."""
