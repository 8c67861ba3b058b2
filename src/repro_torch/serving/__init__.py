"""Serving: the dtANS-compressed ``SparseLinear`` projection."""
