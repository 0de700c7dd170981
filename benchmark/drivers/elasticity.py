"""`ElasticityModel` in 3D on a mesh: one timestep is one fit of the
incremental potential. The mesh is made by the benchmark
(`inputs/statue_mesh.py`) and written into the run's directory."""

from __future__ import annotations

import os

from ..inputs.statue_mesh import statue_tet_mesh, write_medit
from ._base import build, copy_fields, fit_record, run_flags


class Driver:
    def __init__(self, config: dict, workload: dict, seed: int,
                 work_dir: str, device: str):
        self.mesh_path = os.path.join(work_dir, "statue.mesh")
        write_medit(self.mesh_path, *statue_tet_mesh(workload["mesh_n"]))
        argv = run_flags(config, workload, seed, work_dir, device)
        self.cfg, self.model = build(argv + ["--mesh_path", self.mesh_path])
        self.initial_fields = copy_fields(self.model.fields)
        self.inputs = {"mesh_path": self.mesh_path}
        self.produced = {}

    def initialize(self):
        m = self.model
        start = m.fields["deformation"]
        res = m.initialize()
        # the history starts as the t = 0 fit's field
        self.produced = {"deformation": res.params, "prev": res.params}
        return [fit_record("initialize", m.timestep, start, {}, res)]

    def step(self):
        """One timestep. The history the fit read is taken from the model
        after the step, which shifted it (prev_prev <- prev <- the last
        field): it should be the last step's result and its prev."""
        m = self.model
        start = m.fields["deformation"]
        res = m.step()
        prev = m.fields["deformation_prev"]
        prev_prev = m.fields["deformation_prev_prev"]
        handoff = [("deformation", start, self.produced["deformation"]),
                   ("deformation_prev", prev, self.produced["deformation"]),
                   ("deformation_prev_prev", prev_prev,
                    self.produced["prev"])]
        self.produced = {"deformation": res.params, "prev": prev}
        return [fit_record("solve_deformation", m.timestep, start,
                           {"prev": prev, "prev_prev": prev_prev,
                            "t": m.timestep}, res, handoff)]
