"""Sparse-matrix substrate (numpy): CSR/COO/SELL and pruning."""
