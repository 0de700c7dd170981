"""The SIREN forward kernel (`csrc/siren_forward.cu`) as a share of its
roofline, in percent; bound by FLOPs at these widths. Moves `step_s`
through the two history fields of every elasticity iteration."""

from ._kernel import roofline


def read(record: dict):
    return roofline(record, "siren_forward")
