"""The scenes and bars that `chip_smoke.py` and the bench
(`insr_pde_tpu_torch.bench`) both hold the port to, kept in one place: the
fluid Taylor-Green bar, the lucy and 2D collide scenes' flags
(`ELA_3D_ARGS`, `ELA_2D_ARGS`) with the JAX package's per-t statistics at
that cut (`ELA_3D_JAX`, `ELA_2D_JAX`), the plane's bar, and the analytic
yardstick of the 1D advection field (`advect_rel_l2`).

Imports nothing heavy at import time: `chip_smoke.py` and the JAX reference
scripts under `tests/` import it.
"""

from __future__ import annotations

# t=0 velocity after 500 Adam iterations against analytic Taylor-Green
# on the -vr grid: the JAX package reaches 3.6e-2 at this budget (CPU run of
# the same config), the port 3.8e-2 on the CPU at -sr 64. 0.1 leaves room
# for the other point draws and still fails a fit that did not converge.
# The merged2 path is held to the same bar at t = 0, 1 and 2.
TG_REL_L2_BAR = 0.1

# The elasticity paths: scripts/elasticity3Dlucy.sh (SIREN 3x128, -sr 20 =
# 8,000 volume points + every vertex per Adam iteration, -vr 10000) on the
# lucy-scale stand-in, and scripts/elasticity2Dcollide.sh (SIREN 3x68, -sr
# 100 = 10,000 random + 10,000 grid points; the init fit at the reference's
# 500^2 + 500^2), each cut to T=ELA_STEPS and ELA_ITERS Adam iterations per
# fit (the scripts run T=20 at up to 20,000). Widths, point counts, lr, dt
# and energies as published. At T=4 the 3D drop reaches the plane at z = -2,
# so its collision term is at work in the last fit. The JAX reference runs
# (tests/elasticity_reference_jax.py) take these lists as they are.
ELA_STEPS = 4
ELA_ITERS = 300
ELA_MESH_N = 32          # statue_tet_mesh(32): 35,937 vertices, 163,840 tets
ELA_PLANE = -2.0
ELA_3D_ARGS = ["elasticity", "--num_hidden_layers", "3", "--hidden_features",
               "128", "-sr", "20", "-vr", "10000", "-T", str(ELA_STEPS),
               "--dt", "0.1", "--max_n_iters", str(ELA_ITERS), "--lr",
               "1e-4", "--dim", "3", "--energy", "arap", "kinematics",
               "collision", "external", "volume", "--ratio_volume", "1e3",
               "--ratio_arap", "1e3", "--ratio_collide", "1e6",
               "--ratio_kinematics", "1e0", "-f_ext_x", "0", "-f_ext_y", "0",
               "-f_ext_z=-2e1", "-T_ext", "10", "--plane_height",
               str(ELA_PLANE), "--use_mesh", "1", "--early_stop",
               "--no_backup", "--host_rng"]
ELA_2D_ARGS = ["elasticity", "--num_hidden_layers", "3", "--hidden_features",
               "68", "-sr", "100", "-vr", "100", "-T", str(ELA_STEPS),
               "--dt", "0.1", "--max_n_iters", str(ELA_ITERS), "--lr",
               "1e-5", "--dim", "2", "--energy", "arap", "kinematics",
               "collision_sphere", "external", "volume", "--ratio_volume",
               "1e3", "--ratio_arap", "2e1", "--ratio_collide", "1e4",
               "--ratio_kinematics", "1e1", "-f_ext_x", "0", "-f_ext_y=-2e2",
               "-T_ext", "2", "--early_stop", "--no_backup", "--host_rng"]
# The JAX package at the same cut on a CPU, seeds 0-5
# (`python tests/elasticity_reference_jax.py 3d|2d`, PERF.md section 6):
# per quantity and t = 0..ELA_STEPS, the mean over the seeds and their
# spread (max - min). The port's value at each t must lie within 2x that
# t's spread of that t's mean. The 3D fit at t=4, the first in contact
# with the plane, spreads ~25x wider over the seeds than those before it.
# The 2D penetration at t=0 also takes a seventh JAX run, the paired one
# on the port's draws (ELA_2D_PAIRED: 0.004204989): the six seeds all read
# exactly 0 there, a bar of zero width that JAX itself misses on other
# draws.
ELA_3D_JAX = {
    "z_min": ((-1.161975, -1.255353, -1.454716, -1.75446, -1.968614),
              (0.003604, 0.003179, 0.003423, 0.003427, 0.08608)),
    "z_mean": ((-0.08441902, -0.1841616, -0.3839114, -0.6836644,
                -0.8970536),
               (0.003198, 0.003364, 0.003533, 0.003703, 0.08871)),
}
ELA_2D_JAX = {
    "centroid_y": ((-2.931183e-05, -0.08543724, -0.2396635, -0.3653672,
                    -0.4647207),
                   (8.682e-05, 0.006354, 0.01823, 0.02926, 0.03935)),
    "penetration": ((0.0006007127, 0.009386999, 0.01569503, 0.01011736,
                     0.007997869),
                    (0.004204989, 0.01137, 0.004588, 0.003203, 0.001631)),
}
# The lucy drop alone (steps of 0.1, 0.2, 0.3, 0.4) takes z_min to about
# -2.15 at t=4; the plane holds it above ELA_PLANE - ELA_PLANE_SLACK (the JAX
# package's six seeds: -1.998 to -1.912).
ELA_PLANE_SLACK = 0.05


def advect_rel_l2(u, vr, length, vel, dt, t):
    """Rel L2 of an advection field `u` on the -vr grid against the
    analytic bump gaussian_like(x - vel dt t, mu=-1.5, sigma=0.1)."""
    import numpy as np
    from insr_pde_tpu_torch.ops.sampling import sample_uniform
    x = (sample_uniform(vr, 1) * (length / 2.0)).numpy()[:, 0]
    exact = np.exp(-0.5 * (x - vel * dt * t + 1.5) ** 2 / 0.1 ** 2)
    return float(np.linalg.norm(u - exact) / np.linalg.norm(exact))
