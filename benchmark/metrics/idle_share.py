"""Percent of the traced step in which no device operation ran."""


def read(record: dict):
    trace = record.get("trace")
    if not trace or trace["window_s"] <= 0.0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
