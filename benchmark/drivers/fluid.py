"""`Fluid2DModel`, split scheme: one timestep is the advect, pressure and
projection fits."""

from __future__ import annotations

from ._base import build, copy_fields, fit_record, run_flags


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int,
                 work_dir: str, device: str):
        self.cfg, self.model = build(run_flags(config, workload, seed,
                                               work_dir, device))
        self.initial_fields = copy_fields(self.model.fields)
        self.inputs = {}
        # what the fits so far produced for each field a step reads
        self.produced = {"pressure": self.initial_fields["pressure"]}

    def initialize(self):
        m = self.model
        start = m.fields["velocity"]
        res = m.initialize()
        self.produced["velocity"] = res.params
        return [fit_record("initialize", m.timestep, start, {}, res)]

    def step(self):
        """One timestep. The fields are read from the model before and after
        it: what the step started from, and what its later fits read (the
        advected velocity, `velocity_prev` after the step, and the
        pressure)."""
        m = self.model
        vel, pressure = m.fields["velocity"], m.fields["pressure"]
        res_a, res_p, res_j = m.step()
        t = m.timestep
        advected, solved = m.fields["velocity_prev"], m.fields["pressure"]
        handoff = [("velocity", vel, self.produced["velocity"]),
                   ("pressure", pressure, self.produced["pressure"])]
        self.produced = {"velocity": res_j.params, "pressure": res_p.params}
        return [
            fit_record("advect_velocity", t, vel, {"prev": vel}, res_a,
                       handoff),
            fit_record("solve_pressure", t, pressure, {"vel": advected},
                       res_p, [("velocity_prev", advected, res_a.params)]),
            fit_record("projection", t, advected,
                       {"prev": advected, "pressure": solved}, res_j,
                       [("pressure", solved, res_p.params)]),
        ]
