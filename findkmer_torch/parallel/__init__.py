"""Multi-host and multi-device counting of the port.

Only the host-side input sharding exists so far (`multihost.py`); the
device mesh and the collectives are not yet ported (ROADMAP.md Queue 1
item 13).
"""
