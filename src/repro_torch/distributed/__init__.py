"""Distributed-training math: GTC (``gtc.py``) and BMUF (``bmuf.py``),
their W workers or lanes as a loop on one device, or each rank's lanes
on a ``runtime.cluster.WorkerMesh`` of processes with one
``all_reduce`` a leaf between them."""
