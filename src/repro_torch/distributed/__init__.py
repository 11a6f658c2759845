"""Distributed-training math, single-process forms: GTC
(``gtc.py``) and BMUF with its W lanes looped on one device
(``bmuf.py``).  The multi-worker steps come with later slices."""
