"""Per-layer metric readers, one module per metric of `BENCHMARK.json`'s
`per_layer`: `read(record)` returns the number, or None where the run has
nothing to read."""
