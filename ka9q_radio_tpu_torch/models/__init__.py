"""Demodulators of the port."""
