"""Measurement scripts for the port, run on the GPU host."""
