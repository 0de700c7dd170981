"""Milestone rows of a Taylor-Green log (counterpart of
`tools/tg_milestones.py`).

    python -m insr_pde_tpu_torch.tg_milestones RUN.log [t1 t2 ...]

Reads the JSON lines that `python -m insr_pde_tpu_torch.compare_fluid_tg`
prints (or the JAX tool's, the same format) and prints t / rel_l2 / amp /
sec for the requested timesteps (default 0 10 20 ... 100), then the largest
rel_l2 over the horizon, the last step at which rel_l2 <= 1e-3, 3e-3 and
1e-2 (and the end of the run of such steps from t = 0), and the median sec
a step. It reads a file and uses no device.
"""

from __future__ import annotations

import json
import statistics
import sys


def read_rows(path: str) -> list:
    """The log's per-timestep records ({"t", "rel_l2", ...})."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line.startswith("{"):
                continue
            rec = json.loads(line)
            if "t" in rec and "rel_l2" in rec:
                rows.append(rec)
    return rows


def milestones(rows: list, wanted: list) -> list:
    """The lines the tool prints for `rows`."""
    out = []
    by_t = {r["t"]: r for r in rows}
    for t in wanted:
        if t in by_t:
            r = by_t[t]
            out.append(f"t={t:3d}  rel_l2={r['rel_l2']:.3e}  "
                       f"amp={r.get('amp', float('nan')):.6f}  "
                       f"sec={r['sec']}")
    if rows:
        mx = max(rows, key=lambda r: r["rel_l2"])
        out.append(f"max rel_l2 {mx['rel_l2']:.3e} at t={mx['t']}")
        for bar in (1e-3, 3e-3, 1e-2):
            ok = [r["t"] for r in rows if r["rel_l2"] <= bar]
            run = -1
            for t in sorted(by_t):
                if by_t[t]["rel_l2"] <= bar and t == run + 1:
                    run = t
                else:
                    break
            out.append(f"last t with rel_l2<={bar:g}: "
                       f"{max(ok) if ok else None} (contiguous from 0: "
                       f"{run})")
        out.append(f"median sec/step "
                   f"{statistics.median(r['sec'] for r in rows)}")
    return out


def main(argv=None) -> list:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        raise SystemExit("usage: python -m insr_pde_tpu_torch.tg_milestones "
                         "RUN.log [t1 t2 ...]")
    wanted = ([int(x) for x in argv[1:]]
              or [0, 10, 20, 30, 40, 50, 60, 70, 80, 90, 100])
    lines = milestones(read_rows(argv[0]), wanted)
    for line in lines:
        print(line)
    return lines


if __name__ == "__main__":
    main()
