"""Plain PyTorch references, one module per configuration, named as the
configuration is in `BENCHMARK.json`. They import nothing of the program
and nothing of JAX."""
