"""The block-ELL transpose product A^T r (`csrc/block_ell.cu`, its chunk
and column passes) as a share of its roofline, in percent; bound by bytes.
Moves `step_s` through every CGLS iteration of the vortex channel."""

from ._kernel import roofline


def read(record: dict):
    return roofline(record, "block_ell_rmv")
