"""Elasticity by per-timestep variational optimisation (counterpart of
`insr_pde_tpu/models/elasticity.py`).

The displacement d(x) is a SIREN (dim -> dim) and q = x + d(x). Each
timestep minimises the incremental potential E_arap + E_volume +
E_kinematics + E_external + constraints and contact over the network's
weights, with the previous two fields (`deformation_prev`,
`deformation_prev_prev`) as the second-order time scheme's history.

  * The deformation gradient F = I + J^T comes from the SIREN's batched
    forward chain (`MLP.value_grad`, J (N, d, m) = d d_m / d x_d), which
    autograd differentiates with respect to the weights; other networks
    take vmapped jacfwd through the same call.
  * The ARAP and volume energies are `ops/svd.py`'s: finite gradients at the
    rest state F = I.
  * The history nets and the output points are forward-only and go through
    the fused SIREN kernel (`MLP.apply_fused`: `csrc/siren_forward.cu` on
    the card), two launches per Adam iteration of a step.
  * Sampling is a step of its own (`_init_points`, `_step_points`, drawn
    from the model's generator) apart from the pure losses of (params,
    points, aux), so that the tests can hand both packages the same
    points. Mesh vertices and uniform grids are built on the device once.
  * Contact masks are `torch.where` weights on dense tensors
    (`elast_losses.py`); the external force is on while timestep <= T_ext,
    a host bool per fit.
"""

from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from ..geometry import (area_weighted_distribution, boundary_faces,
                        normalize, per_vertex_areas, read_mesh, sample_mesh,
                        sample_surface, volume_weighted_distribution)
from ..ops.sampling import sample_random, sample_uniform
from ..ops.svd import arap_energy, volume_energy
from ..utils import viz
from ..utils.io import write_pointcloud_to_file
from ..utils.viz import (draw_deformation_field2D, draw_deformation_field3D,
                         save_figure)
from .base import BaseModel
from .elast_losses import (collision_plane_loss, collision_sphere_loss,
                           positional_constraint_loss)

_KNOWN_ENERGIES = {"arap", "volume", "kinematics", "external", "constraint",
                   "constraint_right", "constraint_right_compress",
                   "collision", "collision_sphere"}
_CONSTRAINTS = {"constraint", "constraint_right", "constraint_right_compress"}
# offset of the visualisation points' generator seed from cfg.seed (the JAX
# package's PRNGKey(seed + 7919))
VIS_SEED_OFFSET = 7919


class ElasticityModel(BaseModel):
    def __init__(self, cfg):
        super().__init__(cfg)
        self.dim = cfg.dim
        self.net = self._create_field("deformation", self.dim, self.dim)
        self._create_field("deformation_prev", self.dim, self.dim)
        self._create_field("deformation_prev_prev", self.dim, self.dim)
        # the history starts as copies of the current field
        self.fields["deformation_prev"] = self.fields["deformation"]
        self.fields["deformation_prev_prev"] = self.fields["deformation"]
        self._init_params(cfg)

    # ---- static problem set-up ----
    def _init_params(self, cfg):
        unknown = set(cfg.energy) - _KNOWN_ENERGIES
        if unknown:
            raise NotImplementedError(f"energy terms {sorted(unknown)}")
        self.energy = list(cfg.energy)
        self.use_mesh = cfg.use_mesh
        self.sample_pattern = list(cfg.sample_pattern)
        for s in self.sample_pattern:
            if s not in ("random", "uniform"):
                raise NotImplementedError(f"sample_pattern {s!r}")

        self.ratio_arap = cfg.ratio_arap
        self.ratio_volume = cfg.ratio_volume
        self.ratio_kinematics = cfg.ratio_kinematics
        self.ratio_constraint = cfg.ratio_constraint
        self.ratio_collide = cfg.ratio_collide
        self.external_force_timesteps = cfg.external_force_timesteps
        self.plane_height = cfg.plane_height
        self.circle_radius = cfg.collide_circle_radius

        def vec(x, y, z):
            return torch.tensor([x, y, z][:self.dim], dtype=torch.float32,
                                device=self.device)

        self.external_force = vec(cfg.external_force_x, cfg.external_force_y,
                                  cfg.external_force_z)
        self.constraint_offset_right = vec(cfg.constraint_right_offset_x,
                                           cfg.constraint_right_offset_y,
                                           cfg.constraint_right_offset_z)
        self.circle_center = vec(cfg.collide_circle_x, cfg.collide_circle_y,
                                 cfg.collide_circle_z)

        if self.use_mesh:
            self._init_mesh(cfg.mesh_path)

        # points per iteration
        self.n_random = max(1, self.sample_resolution ** self.dim)
        self.n_fixed = max(1, self.sample_resolution)
        # the initialisation fit's resolution: the flag, else the mesh scene's
        # sample resolution, else 500 (2D) / 100 (3D) as the reference
        if cfg.sample_resolution_init:
            self.sample_resolution_init = cfg.sample_resolution_init
        elif self.use_mesh:
            self.sample_resolution_init = self.sample_resolution
        else:
            self.sample_resolution_init = {2: 500, 3: 100}[self.dim]
        self.n_random_init = max(1, self.sample_resolution_init ** self.dim)
        # the box faces' points are drawn only for the constraint terms
        self._draw_faces = (not self.use_mesh
                            and bool(_CONSTRAINTS & set(self.energy)))
        self._grids = {}
        self.sample_vis = self._sample_in_visualization(self.vis_resolution)

    def _init_mesh(self, mesh_path):
        """Load the deformable mesh, centre it and scale it to radius 2."""
        if not os.path.isfile(mesh_path):
            raise FileNotFoundError(
                f"--mesh_path {mesh_path!r}: no such file (--use_mesh 1 needs "
                "a MEDIT .mesh or Wavefront .obj file)")
        data = read_mesh(mesh_path)
        if self.dim == 3:
            F = np.asarray(data.cells_dict["tetra"])
            SF = boundary_faces(F)
        else:
            F = np.asarray(data.cells_dict["triangle"])
            SF = F
        dev = self.device
        self.mesh_SF = torch.as_tensor(SF, dtype=torch.int64, device=dev)
        V = torch.as_tensor(data.points, dtype=torch.float32, device=dev)
        F = torch.as_tensor(F, dtype=torch.int64, device=dev)
        V, F = normalize(V, F)
        V = V * 2.0
        self.mesh_V = V[:, :self.dim].contiguous()
        self.mesh_V3 = V  # the samplers take the (V, 3) coordinates
        self.mesh_F = F
        self.vertex_area = per_vertex_areas(V, F)
        if self.dim == 3:
            self.distrib = volume_weighted_distribution(V, F)
        else:
            self.distrib = area_weighted_distribution(V, F)

    # ---- sampling steps (model generator) ----
    def _grid(self, resolution, sdim):
        """The uniform grid, built on the device once."""
        key = (resolution, sdim)
        if key not in self._grids:
            self._grids[key] = sample_uniform(resolution, sdim,
                                              device=self.device)
        return self._grids[key]

    def _sample_in_training(self, n_random, resolution=None):
        """The sample pattern's points: 'random' draws volume (mesh) or box
        points, 'uniform' is every mesh vertex or the uniform grid at
        `resolution` (the init fit's resolution during the init fit)."""
        resolution = resolution or self.sample_resolution
        parts = []
        for s in self.sample_pattern:
            if s == "random":
                if self.use_mesh:
                    parts.append(sample_mesh(self.generator, self.mesh_V3,
                                             self.mesh_F, n_random,
                                             self.distrib)[:, :self.dim])
                else:
                    parts.append(sample_random(self.generator, n_random,
                                               self.dim))
            else:
                parts.append(self.mesh_V if self.use_mesh
                             else self._grid(resolution, self.dim))
        return torch.cat(parts, dim=0)

    def _sample_fixed_in_training(self):
        """Points on the box's left and right faces (x = -1 and x = +1),
        for the constraint terms; box scenes only."""
        left, right = [], []
        for s in self.sample_pattern:
            if s == "random":
                rest = sample_random(self.generator, self.n_fixed,
                                     self.dim - 1)
            else:
                rest = self._grid(self.sample_resolution, self.dim - 1)
            ones = torch.ones((rest.shape[0], 1), dtype=rest.dtype,
                              device=rest.device)
            left.append(torch.cat([-ones, rest], dim=1))
            right.append(torch.cat([ones, rest], dim=1))
        return torch.cat(left, 0), torch.cat(right, 0)

    def _init_points(self):
        return {"x": self._sample_in_training(
            self.n_random_init, resolution=self.sample_resolution_init)}

    def _step_points(self):
        pts = {"x": self._sample_in_training(self.n_random)}
        if self._draw_faces:
            pts["left"], pts["right"] = self._sample_fixed_in_training()
        return pts

    # ---- pure loss functions of (params, points, aux) ----
    def _init_loss(self, params, pts, aux):
        """Fit the displacement to 0."""
        out = self.net.apply(params, pts["x"])
        return {"main": torch.mean(out ** 2)}

    def deformation_gradient(self, params, x):
        """(q (N, d), F (N, d, d)) with F[:, i, j] = d q_i / d x_j."""
        d, J = self.net.value_grad(params, x)          # J (N, d, m)
        eye = torch.eye(self.dim, dtype=x.dtype, device=x.device)
        return d + x, eye + J.transpose(1, 2)

    def _deformation_loss(self, params, pts, aux):
        """The incremental potential. aux: the history fields `prev` and
        `prev_prev`, and `external` (host bool: timestep <= T_ext)."""
        x = pts["x"]
        q, jac = self.deformation_gradient(params, x)
        with torch.no_grad():
            q_prev = self.net.apply_fused(aux["prev"], x) + x
            q_prev_prev = self.net.apply_fused(aux["prev_prev"], x) + x
        qdot = (q - q_prev) / self.dt
        qdot_prev = (q_prev - q_prev_prev) / self.dt

        terms = []
        for term in self.energy:
            if term == "arap":
                terms.append(self.ratio_arap * arap_energy(jac))
            elif term == "volume":
                terms.append(self.ratio_volume * volume_energy(jac))
            elif term == "kinematics":
                terms.append(self.ratio_kinematics
                             * torch.sum((qdot - qdot_prev) ** 2))
            elif term == "external":
                if aux["external"]:
                    terms.append(-self.dt * torch.sum(
                        qdot * self.external_force))
            elif term == "constraint":
                terms.append(positional_constraint_loss(
                    self.net.apply(params, pts["left"]), 0.0,
                    self.ratio_constraint))
            elif term == "constraint_right":
                terms.append(positional_constraint_loss(
                    self.net.apply(params, pts["right"]),
                    self.constraint_offset_right, self.ratio_constraint))
            elif term == "constraint_right_compress":
                terms.append(positional_constraint_loss(
                    self.net.apply(params, pts["right"]),
                    -self.constraint_offset_right, self.ratio_constraint))
            elif term == "collision":
                terms.append(collision_plane_loss(
                    q, qdot, self.dt, self.ratio_collide, self.plane_height))
            elif term == "collision_sphere":
                terms.append(collision_sphere_loss(
                    q, qdot, self.dt, self.ratio_collide, self.circle_center,
                    self.circle_radius))
        # no active term (e.g. only `external`, past T_ext): a zero that
        # keeps the graph, so the fit takes zero steps as the JAX one does
        loss = torch.stack(terms).sum() if terms else 0.0 * q.sum()
        return {"main": loss}

    # ---- timestep protocol ----
    def initialize(self):
        self.begin_timestep()
        res = self._run_phase("initialize", self._init_loss,
                              self._init_points, self.fields["deformation"],
                              aux=None, vis_fn=self._vis_deformation)
        self.fields["deformation"] = res.params
        self.fields["deformation_prev"] = res.params
        self.fields["deformation_prev_prev"] = res.params
        self.end_timestep()
        return res

    def step(self):
        """Shift the history, then minimise the incremental potential."""
        self.begin_timestep()
        self.fields["deformation_prev_prev"] = self.fields["deformation_prev"]
        self.fields["deformation_prev"] = self.fields["deformation"]
        aux = {"prev": self.fields["deformation_prev"],
               "prev_prev": self.fields["deformation_prev_prev"],
               "external": self.timestep <= self.external_force_timesteps}
        res = self._run_phase("solve_deformation", self._deformation_loss,
                              self._step_points, self.fields["deformation"],
                              aux=aux, vis_fn=self._vis_deformation)
        self.fields["deformation"] = res.params
        self.end_timestep()
        return res

    # ---- visualisation and output ----
    def _sample_in_visualization(self, resolution):
        """The output points: mesh surface points drawn from a generator
        of fixed seed (cfg.seed + 7919) plus every vertex, or the box's grid
        and its left and right faces."""
        if self.use_mesh:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.cfg.seed + VIS_SEED_OFFSET)
            surf = sample_surface(gen, self.mesh_V3, self.mesh_SF,
                                  resolution)[:, :self.dim]
            return torch.cat([surf, self.mesh_V], dim=0).contiguous()
        res = min(resolution, 64) if self.dim == 3 else min(resolution, 200)
        samples = sample_uniform(res, self.dim, device=self.device)
        rest = sample_uniform(res, self.dim - 1, device=self.device)
        ones = torch.ones((rest.shape[0], 1), dtype=rest.dtype,
                          device=rest.device)
        left = torch.cat([-ones, rest], dim=1)
        right = torch.cat([ones, rest], dim=1)
        return torch.cat([samples, left, right], dim=0).contiguous()

    @torch.no_grad()
    def sample_deformation(self, params=None):
        """q = x + d(x) at the output points, through the fused kernel."""
        if params is None:
            params = self.fields["deformation"]
        x = self.sample_vis
        return self.net.apply_fused(params, x) + x

    def _vis_deformation(self, params):
        pts = self.sample_deformation(params).cpu().numpy()
        self.tb.add_figure("stepU", self._draw(pts),
                           global_step=self.train_step)

    def _draw(self, pts):
        color = pts.sum(axis=1)
        sphere = "collision_sphere" in self.energy
        center = self.circle_center.cpu().numpy() if sphere else None
        radius = self.circle_radius if sphere else None
        if self.dim == 2:
            return draw_deformation_field2D(
                pts, color=color, plane_height=self.plane_height,
                circle_center=center, circle_radius=radius)
        return draw_deformation_field3D(
            pts, color=color, plane_height=self.plane_height,
            sphere_center=center, sphere_radius=radius)

    def write_output(self, output_folder):
        """tNNN_deformation.ply (the JAX package's file) and .npy (the same
        points as float32), and the PNG where matplotlib is installed."""
        pts = self.sample_deformation().cpu().numpy()
        stem = os.path.join(output_folder, f"t{self.timestep:03d}_deformation")
        np.save(stem + ".npy", pts)
        write_pointcloud_to_file(stem + ".ply", pts)
        if not viz.available():
            warnings.warn("matplotlib is not installed: write_output saves "
                          "the .ply and .npy points but no PNG figure")
            return
        save_figure(self._draw(pts), stem + ".png")
