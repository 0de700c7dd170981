"""PyTorch port, checkpoints: the same path-keyed .npz as the JAX package, so
a JAX checkpoint loads in the port and a port checkpoint loads in the JAX
package, leaf for leaf and bit for bit."""

import jax
import numpy as np
import pytest
import torch

from insr_pde_tpu.config import Config as JConfig
from insr_pde_tpu.models.fluid import Fluid2DModel as JFluid
from insr_pde_tpu.utils.ckpt import load_pytree as jload
from insr_pde_tpu_torch.config import Config as TConfig
from insr_pde_tpu_torch.models.fluid import Fluid2DModel as TFluid
from insr_pde_tpu_torch.utils.ckpt import load_pytree, save_pytree

torch.set_num_threads(1)

KW = dict(pde="fluid", init_cond="taylorgreen", num_hidden_layers=2,
          hidden_features=8, sample_resolution=8, vis_resolution=8,
          backup_sources=False, tag="ckpt")


def _leaves(fields):
    return [np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)
            for x in jax.tree_util.tree_leaves(
                {k: [list(wb) for wb in v] for k, v in fields.items()})]


@pytest.fixture
def models(tmp_path):
    jcfg = JConfig(proj_dir=str(tmp_path), **KW)
    tcfg = TConfig(proj_dir=str(tmp_path), device="cpu", seed=5, **KW)
    jcfg.setup_dirs()
    return JFluid(jcfg), TFluid(tcfg)


def test_jax_checkpoint_resumes_in_port(models):
    jm, tm = models
    jm.timestep = 3
    jm.save_ckpt()
    assert not np.array_equal(_leaves(jm.fields)[0], _leaves(tm.fields)[0])
    tm.load_ckpt("latest")
    assert tm.timestep == 3
    for a, b in zip(_leaves(jm.fields), _leaves(tm.fields)):
        np.testing.assert_array_equal(a, b)
    assert all(isinstance(w, torch.Tensor) and w.dtype == torch.float32
               for w, _ in tm.fields["velocity"])


def test_port_checkpoint_resumes_in_jax(models):
    jm, tm = models
    tm.timestep = 7
    tm.save_ckpt()
    jm.load_ckpt(7)
    assert jm.timestep == 7
    for a, b in zip(_leaves(tm.fields), _leaves(jm.fields)):
        np.testing.assert_array_equal(a, b)
    # the keys are the JAX keystr paths, e.g. ['velocity'][0][0]
    path = f"{tm.cfg.model_dir}/ckpt_step_t007.npz"
    _, meta = jload(path, jm.fields)
    assert int(meta["timestep"]) == 7
    with np.load(path) as data:
        assert "['velocity'][0][0]" in data.files
        assert "['pressure'][2][1]" in data.files


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_merged2_checkpoint_with_pressure_prev_loads_across(tmp_path, writer):
    """merged2 models create the `pressure_prev` leaf (q_old of the
    trapezoidal chain) before any load, so a merged2 checkpoint written by
    either package restores q_old in the other, leaf for leaf, and the
    resumed run continues the chain instead of bootstrapping again."""
    kw = {**KW, "fluid_step": "merged2"}
    jcfg = JConfig(proj_dir=str(tmp_path), **kw)
    jcfg.setup_dirs()
    jm = JFluid(jcfg)
    tm = TFluid(TConfig(proj_dir=str(tmp_path), device="cpu", seed=5, **kw))
    assert "pressure_prev" in jm.fields and "pressure_prev" in tm.fields
    src, dst = (jm, tm) if writer == "jax" else (tm, jm)
    # a q_old apart from the pressure, as after a trapezoidal step
    src.fields["pressure_prev"] = [(w * 0 + 0.25, b * 0 - 0.5)
                                   for w, b in src.fields["pressure"]]
    src.timestep = 4
    src.save_ckpt()
    dst.load_ckpt("latest")
    assert dst.timestep == 4
    for a, b in zip(_leaves(src.fields), _leaves(dst.fields)):
        np.testing.assert_array_equal(a, b)
    q = _leaves({"q": dst.fields["pressure_prev"]})
    assert q[-1].tolist() == [-0.5] and (q[-2] == 0.25).all()


def test_load_checks_structure(tmp_path):
    tree = {"a": [(torch.zeros(2, 3), torch.ones(3))]}
    path = str(tmp_path / "t.npz")
    save_pytree(path, tree, metadata={"timestep": 1})
    with pytest.raises(ValueError, match="shape"):
        load_pytree(path, {"a": [(torch.zeros(3, 3), torch.ones(3))]})
    with pytest.raises(KeyError):
        load_pytree(path, {"b": [(torch.zeros(2, 3), torch.ones(3))]})
