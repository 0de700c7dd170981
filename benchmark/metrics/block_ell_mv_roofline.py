"""The block-ELL product A x (`csrc/block_ell.cu`: its ring kernel at the
channel's J = 16, the plain one elsewhere) as a share of its roofline, in
percent; bound by bytes. Moves `step_s` through every CGLS iteration of
the vortex channel."""

from ._kernel import roofline


def read(record: dict):
    return roofline(record, "block_ell_mv")
