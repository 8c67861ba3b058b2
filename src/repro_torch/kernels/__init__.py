"""Decode-on-the-fly kernels: the plain torch decoder, the CUDA kernels,
their wrappers and the public ``ops`` entry points."""
