"""Plain NumPy / PyTorch references the benchmark judges the port by.

Nothing here imports the port (``repro_torch``) or the JAX package, and
nothing takes a weight, table or pack that the port made: each reference
works its matrix out again from the inputs the benchmark made.
"""
