"""Inputs the benchmark makes itself and hands to both the program and the
reference."""
