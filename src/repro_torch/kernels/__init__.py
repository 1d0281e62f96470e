"""Hopper kernels of the port, their plain-torch versions and dispatch."""
