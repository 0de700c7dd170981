"""PyTorch port, `geometry/` against the JAX package's `geometry/`: the
procedural meshes bit for bit, MEDIT files written by either package read
by the other, OBJ reading, boundary faces, the measures, the distributions
and `normalize` on the same inputs, and the samplers (their draws differ
from `jax.random`'s, so they are held to what they must give: points inside
the elements, barycentric weights that sum to 1, element frequencies that
follow the distribution)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu import geometry as jgeo
from insr_pde_tpu_torch import geometry as tgeo
from insr_pde_tpu_torch.geometry import mesh_ops as tops

torch.set_num_threads(1)


def _gen(seed=0):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


@pytest.mark.parametrize("name,n", [("box_tri_mesh", 5), ("box_tet_mesh", 3),
                                    ("statue_tet_mesh", 4)])
def test_procedural_meshes_equal_jax_bit_for_bit(name, n):
    jV, jF = getattr(jgeo, name)(n)
    tV, tF = getattr(tgeo, name)(n)
    assert tV.dtype == jV.dtype and tF.dtype == jF.dtype
    np.testing.assert_array_equal(tV, jV)
    np.testing.assert_array_equal(tF, jF)


def test_statue_mesh_has_the_lucy_scale_counts():
    V, T = tgeo.statue_tet_mesh(32)
    assert V.shape == (35937, 3) and T.shape == (163840, 4)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_medit_written_by_either_package_reads_in_the_other(tmp_path, writer):
    V, T = tgeo.statue_tet_mesh(3)
    path = str(tmp_path / "m.mesh")
    (jgeo if writer == "jax" else tgeo).write_medit(path, V, {"tetra": T})
    for reader in (jgeo.read_mesh, tgeo.read_mesh):
        data = reader(path)
        np.testing.assert_allclose(data.points, V, rtol=1e-8, atol=1e-9)
        np.testing.assert_array_equal(data.cells_dict["tetra"], T)


def test_medit_writers_give_the_same_bytes(tmp_path):
    V, F = tgeo.box_tri_mesh(3)
    a, b = str(tmp_path / "a.mesh"), str(tmp_path / "b.mesh")
    jgeo.write_medit(a, V, {"triangle": F})
    tgeo.write_medit(b, V, {"triangle": F})
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()


def test_medit_2d_vertices_and_unknown_sections(tmp_path):
    path = tmp_path / "t.mesh"
    path.write_text("MeshVersionFormatted 1\nDimension 2\nVertices\n3\n"
                    "0 0 1\n1 0 1\n0 1 1\nCorners\n1\n1\nTriangles\n1\n"
                    "1 2 3 7\nEnd\n")
    t, j = tgeo.read_medit(str(path)), jgeo.read_medit(str(path))
    np.testing.assert_array_equal(t.points, j.points)
    assert t.points.shape == (3, 3) and not t.points[:, 2].any()
    np.testing.assert_array_equal(t.cells_dict["triangle"], [[0, 1, 2]])
    bad = tmp_path / "bad.mesh"
    bad.write_text("MeshVersionFormatted 1\nDimension 3\nEnd\n")
    with pytest.raises(ValueError, match="no Vertices"):
        tgeo.read_medit(str(bad))


def test_read_obj_matches_jax(tmp_path):
    path = tmp_path / "q.obj"
    path.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0 0 1\n"
                    "f 1/1 2/2 3/3 4/4\nf 1 2 5\n")
    t, j = tgeo.read_mesh(str(path)), jgeo.read_mesh(str(path))
    np.testing.assert_array_equal(t.points, j.points)
    np.testing.assert_array_equal(t.cells_dict["triangle"],
                                  j.cells_dict["triangle"])
    with pytest.raises(NotImplementedError):
        tgeo.read_mesh(str(tmp_path / "x.ply"))


@pytest.mark.parametrize("n", [2, 3])
def test_boundary_faces_equal_jax(n):
    _, T = tgeo.box_tet_mesh(n)
    got = tgeo.boundary_faces(T)
    np.testing.assert_array_equal(got, jgeo.boundary_faces(T))
    assert len(got) == 6 * 2 * n * n     # two triangles per boundary square


def _mesh(kind):
    if kind == "tri":
        V, F = tgeo.box_tri_mesh(4)
        V = V + 0.1 * np.sin(7.0 * V[:, [1, 2, 0]])   # unequal areas
    else:
        V, F = tgeo.statue_tet_mesh(3)
    return V.astype(np.float32), F


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_measures_and_distributions_match_jax(kind):
    """Areas, volumes, normals, per-vertex lumped measure (the scatter-add
    on the host) and the distributions, f32 on both sides: rtol 1e-5."""
    V, F = _mesh(kind)
    jV, jF = jnp.asarray(V), jnp.asarray(F)
    tV, tF = torch.from_numpy(V), torch.from_numpy(F)
    pairs = [(tgeo.per_vertex_areas(tV, tF), jgeo.per_vertex_areas(jV, jF))]
    if kind == "tri":
        pairs += [(tgeo.per_face_normals(tV, tF),
                   jgeo.per_face_normals(jV, jF)),
                  (tgeo.per_face_areas(tV, tF), jgeo.per_face_areas(jV, jF)),
                  (tgeo.area_weighted_distribution(tV, tF),
                   jgeo.area_weighted_distribution(jV, jF))]
    else:
        pairs += [(tgeo.per_tet_volumes(tV, tF),
                   jgeo.per_tet_volumes(jV, jF)),
                  (tgeo.volume_weighted_distribution(tV, tF),
                   jgeo.volume_weighted_distribution(jV, jF))]
    for got, ref in pairs:
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-7)
    # every element's measure lands on its vertices: the lumped sum is the
    # total measure
    total = (tgeo.per_face_areas(tV, tF) if kind == "tri"
             else tgeo.per_tet_volumes(tV, tF)).sum()
    np.testing.assert_allclose(pairs[0][0].sum().item(), total.item(),
                               rtol=1e-5)


def test_per_face_areas_of_2d_vertices_match_jax():
    V, F = _mesh("tri")
    V2 = np.ascontiguousarray(V[:, :2])
    np.testing.assert_allclose(
        tgeo.per_face_areas(torch.from_numpy(V2), torch.from_numpy(F)).numpy(),
        np.asarray(jgeo.per_face_areas(jnp.asarray(V2), jnp.asarray(F))),
        rtol=1e-5)


def test_normalize_matches_jax():
    V, T = _mesh("tet")
    tV, _ = tgeo.normalize(torch.from_numpy(V), torch.from_numpy(T))
    jV, _ = jgeo.normalize(jnp.asarray(V), jnp.asarray(T))
    np.testing.assert_allclose(tV.numpy(), np.asarray(jV), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(torch.linalg.norm(tV, dim=1).max().item(), 1.0,
                               rtol=1e-6)


def test_barycentric_coordinates_and_sample_tex_match_jax():
    rng = np.random.default_rng(0)
    A, B, C, P = (rng.standard_normal((16, 3)).astype(np.float32)
                  for _ in range(4))
    np.testing.assert_allclose(
        tgeo.barycentric_coordinates(*map(torch.from_numpy, (P, A, B, C))),
        np.asarray(jgeo.barycentric_coordinates(*map(jnp.asarray,
                                                     (P, A, B, C)))),
        rtol=1e-4, atol=1e-5)
    tex = rng.random((2, 5, 7, 3)).astype(np.float32)
    uv = rng.random((32, 2)).astype(np.float32) * 1.2 - 0.1
    mat = rng.integers(0, 2, 32)
    np.testing.assert_allclose(
        tgeo.sample_tex(torch.from_numpy(uv), torch.from_numpy(mat),
                        torch.from_numpy(tex)).numpy(),
        np.asarray(jgeo.sample_tex(jnp.asarray(uv), jnp.asarray(mat),
                                   jnp.asarray(tex))), rtol=1e-6, atol=1e-6)


def _one_tet():
    V = np.array([[0.1, 0.0, 0.0], [1.0, 0.2, 0.0], [0.0, 1.0, 0.3],
                  [0.2, 0.1, 1.0]], np.float32)
    return torch.from_numpy(V), torch.tensor([[0, 1, 2, 3]])


def test_sample_volume_points_lie_in_their_tet():
    """Dirichlet(1,1,1,1) weights from -log(1 - U): every point a convex
    combination of the tet's corners (weights >= 0 summing to 1), and the
    weights' mean 1/4 each (4,000 points: within 0.02)."""
    V, T = _one_tet()
    x = tgeo.sample_volume(_gen(), V, T, 4000)
    assert x.shape == (4000, 3) and x.dtype == torch.float32
    M = torch.cat([V[1:] - V[0]], 0).T.double()           # (3, 3)
    lam = torch.linalg.solve(M, (x - V[0]).double().T).T   # (n, 3)
    w = torch.cat([1.0 - lam.sum(1, keepdim=True), lam], 1)
    assert (w > -1e-5).all()
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-6)
    np.testing.assert_allclose(w.mean(0).numpy(), 0.25, atol=0.02)


def test_sample_surface_points_lie_on_their_triangle():
    V = torch.tensor([[0.0, 0.0, 0.0], [2.0, 0.0, 0.5], [0.0, 1.0, 0.0]])
    F = torch.tensor([[0, 1, 2]])
    x = tgeo.sample_surface(_gen(1), V, F, 2000)
    w = tgeo.barycentric_coordinates(x, V[0], V[1], V[2])
    assert (w > -1e-5).all()
    np.testing.assert_allclose(w.sum(1).numpy(), 1.0, atol=1e-5)
    # uniform on the triangle: the centroid is the corners' mean
    np.testing.assert_allclose(x.mean(0).numpy(), V.mean(0).numpy(),
                               atol=0.03)


@pytest.mark.parametrize("kind", ["tri", "tet"])
def test_element_draws_follow_the_distribution(kind):
    """Inverse-CDF element draws: frequencies within 4 standard errors of
    the area/volume distribution, every index in range."""
    V, F = map(torch.from_numpy, _mesh(kind))
    if kind == "tri":
        p = tgeo.area_weighted_distribution(V, F)
        idx = tgeo.random_face(_gen(2), V, F, 200_000)
    else:
        p = tgeo.volume_weighted_distribution(V, F)
        idx = tgeo.random_tet(_gen(2), V, F, 200_000)
    assert idx.min() >= 0 and idx.max() < len(F)
    freq = torch.bincount(idx, minlength=len(F)).double() / idx.numel()
    se = torch.sqrt(p.double() * (1 - p.double()) / idx.numel())
    assert ((freq - p.double()).abs() <= 4 * se + 1e-6).all()


def test_categorical_clamps_to_the_last_element():
    """A uniform at the top of the cumulative sum (rounded up past it)
    still names an element."""
    probs = torch.tensor([0.25, 0.25, 0.5])
    g = _gen(3)
    idx = tops._categorical(g, probs, 50_000)
    assert idx.max().item() == 2 and idx.min().item() == 0
    probs = torch.tensor([0.3, 0.3, 0.3])        # sums to 0.9, not 1
    assert tops._categorical(g, probs, 1000).max().item() <= 2


def test_categorical_is_the_float64_inverse_cdf():
    """The element draws are numpy's float64 inverse CDF of the same
    uniforms, index for index, also over 163,840 elements (the lucy-scale
    stand-in's tet count), where a float32 running sum would move the
    boundaries by more than an element."""
    rng = np.random.default_rng(0)
    probs = torch.from_numpy(rng.random(163_840).astype(np.float32))
    probs = probs / probs.sum()
    u = torch.rand((20_000,), generator=_gen(4), dtype=torch.float32)
    cdf = np.cumsum(probs.numpy().astype(np.float64))
    want = np.minimum(np.searchsorted(cdf, u.numpy().astype(np.float64)
                                      * cdf[-1], side="right"),
                      len(cdf) - 1)
    got = tops._categorical(_gen(4), probs, 20_000)
    np.testing.assert_array_equal(got.numpy(), want)


def test_samplers_are_deterministic_per_generator_and_on_its_device():
    V, T = map(torch.from_numpy, _mesh("tet"))
    a = tgeo.sample_mesh(_gen(5), V, T, 64)
    b = tgeo.sample_mesh(_gen(5), V, T, 64)
    assert torch.equal(a, b) and a.device == V.device
    lo, hi = V.min(0).values, V.max(0).values
    assert ((a >= lo - 1e-6) & (a <= hi + 1e-6)).all()
    Vt, Ft = map(torch.from_numpy, _mesh("tri"))
    assert tgeo.sample_mesh(_gen(5), Vt, Ft, 10).shape == (10, 3)
    with pytest.raises(NotImplementedError):
        tgeo.sample_mesh(_gen(), V, torch.zeros((2, 5), dtype=torch.int64), 4)


def test_point_sample_near_surface_and_spc_shapes():
    Vt, Ft = map(torch.from_numpy, _mesh("tri"))
    pts = tgeo.point_sample(_gen(6), Vt, Ft, ["rand", "near", "trace"], 50)
    assert pts.shape == (150, 3)
    assert (pts[:50].abs() <= 1.0).all()
    near = tgeo.sample_near_surface(_gen(7), Vt, Ft, 100, variance=0.0)
    assert torch.equal(near, tgeo.sample_surface(_gen(7), Vt, Ft, 100))
    corners = torch.tensor([[0.0, 0.0, 0.0], [3.0, 1.0, 2.0]])
    spc = tgeo.sample_spc(_gen(8), corners, 2, 10)
    assert spc.shape == (20, 3) and (spc.abs() <= 1.0 + 1e-6).all()
    with pytest.raises(NotImplementedError):
        tgeo.point_sample(_gen(), Vt, Ft, ["bogus"], 4)
