"""Traversal kernels, their plain torch versions and the backend."""
