"""Distributed-training math on one device: GTC (``gtc.py``; its W
workers as a loop) and BMUF (``bmuf.py``; its W lanes as a loop).  The
steps over process groups come with ROADMAP Queue 1, step 8."""
