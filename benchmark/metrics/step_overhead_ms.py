"""Milliseconds of each window step spent outside its fits: the step's wall
time less the seconds the program's `phase_timings` give its fits, averaged
over the window's steps (outputs, checkpoints, history shifts)."""


def read(record: dict):
    window = record["window"]
    fit_s = {}
    for f in record["fits"]:
        fit_s[f["t"]] = fit_s.get(f["t"], 0.0) + f["sec"]
    gaps = [wall - fit_s.get(t, 0.0)
            for wall, t in zip(window["walls"], window["timesteps"])]
    return 1e3 * sum(gaps) / len(gaps) if gaps else None
