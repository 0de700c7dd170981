"""Device operations (kernels, copies, fills) per Adam iteration of the
traced step."""


def read(record: dict):
    trace = record.get("trace")
    if not trace or not trace["iters"]:
        return None
    return trace["device_ops"] / trace["iters"]
