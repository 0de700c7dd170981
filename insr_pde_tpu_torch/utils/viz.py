"""Visualization helpers (matplotlib, host-side).

Copied from `insr_pde_tpu/utils/viz.py` (numpy, scipy and matplotlib), so
the port imports nothing of the JAX package. One change: matplotlib is
imported when a figure is drawn, not when the module is imported, so that the
port runs where matplotlib is not installed (`available()` says whether
figures can be drawn; the callers skip them, with a warning, where not).

Covers the drawing surface of the reference's per-model visualize modules
(advection/visualize.py, fluid/visualize.py:7-55, elasticity/visualize.py:13-75,
vortex/visualize.py:7-21) with one shared module.
"""

from __future__ import annotations

import importlib.util

import numpy as np
from scipy.special import erf


def available() -> bool:
    """Whether matplotlib is installed, i.e. whether figures can be drawn."""
    return importlib.util.find_spec("matplotlib") is not None


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _cm():
    from matplotlib import cm
    return cm


def draw_signal1D(x, y, y_max=None, label=None):
    """1D line plot (reference advection/visualize.py)."""
    fig, ax = _plt().subplots(figsize=(6, 3))
    ax.plot(x, y, label=label)
    if y_max is not None:
        ax.set_ylim(-0.1 * y_max, y_max * 1.1)
    fig.tight_layout()
    return fig


def draw_scalar_field2D(arr, vmin=None, vmax=None, cmap="viridis"):
    fig, ax = _plt().subplots(figsize=(4, 4))
    im = ax.imshow(np.asarray(arr).T, origin="lower", vmin=vmin, vmax=vmax,
                   cmap=cmap)
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    return fig


def draw_vector_field2D(vel, coords):
    """Quiver plot of a (..., 2) velocity field at (..., 2) coords
    (reference fluid/visualize.py)."""
    vel = np.asarray(vel).reshape(-1, 2)
    coords = np.asarray(coords).reshape(-1, 2)
    fig, ax = _plt().subplots(figsize=(4, 4))
    ax.quiver(coords[:, 0], coords[:, 1], vel[:, 0], vel[:, 1], scale=25)
    ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def draw_magnitude(mag):
    """Speed magnitude to a uint8 image via erf + Blues colormap
    (reference fluid/visualize.py draw_magnitude)."""
    mag = np.asarray(mag)
    img = erf(mag)
    img = _cm().Blues(img.T)[::-1]
    return (img * 255).astype(np.uint8)


def draw_curl(curl):
    """Curl to a uint8 image via erf + bwr diverging colormap
    (reference fluid/visualize.py draw_curl)."""
    curl = np.asarray(curl)
    img = erf(curl) * 0.5 + 0.5
    img = _cm().bwr(img.T)[::-1]
    return (img * 255).astype(np.uint8)


def draw_scatter2D(coords, values, cmap="viridis", s=2.0):
    """Colored point scatter (reference vortex/visualize.py
    draw_vector_field2D renders speed as a scatter)."""
    coords = np.asarray(coords).reshape(-1, 2)
    values = np.asarray(values).reshape(-1)
    fig, ax = _plt().subplots(figsize=(4, 4))
    sc = ax.scatter(coords[:, 0], coords[:, 1], c=values, cmap=cmap, s=s)
    fig.colorbar(sc, ax=ax)
    ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def save_numpy_img(img, path):
    try:
        from PIL import Image
        Image.fromarray(img).save(path)
    except ImportError:
        _plt().imsave(path, img)


def save_figure(fig, path):
    fig.savefig(path, dpi=120)
    _plt().close(fig)


def draw_deformation_field2D(points, color=None, plane_height=None,
                             circle_center=None, circle_radius=None):
    """2D deformed point scatter with optional plane/circle obstacles
    (reference elasticity/visualize.py)."""
    points = np.asarray(points)
    fig, ax = _plt().subplots(figsize=(5, 5))
    ax.scatter(points[:, 0], points[:, 1], s=1, c=color, cmap="viridis")
    if plane_height is not None and plane_height > -2.0 + 1e-9:
        ax.axhline(y=plane_height, color="k", lw=1)
    if circle_center is not None and circle_radius is not None:
        cc = np.asarray(circle_center)
        ax.add_patch(_plt().Circle((cc[0], cc[1]), circle_radius,
                                fill=False, color="r"))
    ax.set_xlim(-4, 4)
    ax.set_ylim(-4, 4)
    ax.set_aspect("equal")
    fig.tight_layout()
    return fig


def draw_deformation_field3D(points, color=None, plane_height=None,
                             sphere_center=None, sphere_radius=None):
    """3D deformed point scatter (reference elasticity/visualize.py)."""
    points = np.asarray(points)
    fig = _plt().figure(figsize=(5, 5))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(points[:, 0], points[:, 1], points[:, 2], s=1, c=color,
               cmap="viridis")
    if plane_height is not None:
        xx, yy = np.meshgrid(np.linspace(-2, 2, 2), np.linspace(-2, 2, 2))
        ax.plot_surface(xx, yy, np.full_like(xx, plane_height), alpha=0.2)
    if sphere_center is not None and sphere_radius is not None:
        u, v = np.mgrid[0:2 * np.pi:16j, 0:np.pi:8j]
        cc = np.asarray(sphere_center)
        ax.plot_wireframe(cc[0] + sphere_radius * np.cos(u) * np.sin(v),
                          cc[1] + sphere_radius * np.sin(u) * np.sin(v),
                          cc[2] + sphere_radius * np.cos(v),
                          color="r", lw=0.3)
    ax.set_xlim(-3, 3)
    ax.set_ylim(-3, 3)
    ax.set_zlim(-3, 3)
    return fig
