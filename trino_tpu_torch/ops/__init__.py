"""Relational operators and the device kernels under them."""
