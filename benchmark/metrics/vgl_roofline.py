"""The vgl kernel pair (`csrc/siren_vgl.cu`: forward, backward and its
reduction) as a share of its roofline, in percent; bound by FLOPs at these
widths. Moves `step_s` through the pressure fit."""

from ._kernel import roofline


def read(record: dict):
    return roofline(record, "siren_vgl")
