"""Distributed runtime of the port: the ZeRO-3 layout and its
collectives."""
