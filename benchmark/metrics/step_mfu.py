"""The window's Adam-iteration FLOPs, counted from shapes
(`flops/<config>.py`), over the window's seconds, as a percent of one
H100's FP32 peak (TF32 off)."""


def read(record: dict):
    flops = record["iter_flops"]
    total = sum(flops[f["tag"]] * f["n_iters"] for f in record["fits"]
                if f["tag"] in flops)
    seconds = record["window"]["seconds"]
    if not total or seconds <= 0.0:
        return None
    return 100.0 * total / seconds / record["peaks"]["fp32_flops"]
