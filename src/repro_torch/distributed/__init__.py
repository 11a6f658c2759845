"""Distributed-training math.  Only GTC's single-process form is ported;
BMUF and the multi-worker steps come with later slices."""
