"""insr_pde_tpu_torch — the PyTorch/CUDA port of `insr_pde_tpu` for one NVIDIA H100.

A second package beside the JAX one, with the same module layout so that each
module's counterpart is easy to find (`config`, `ops/…`, `models/…`,
`utils/…`). It imports `torch`, numpy, scipy and matplotlib, and nothing of
JAX or of `insr_pde_tpu`. Every TPU kernel of a ported path becomes a kernel
written by hand for Hopper under `csrc/`, built by `nvcc` at first use.

Ported: the 2D fluid model (`models/fluid.py`), 1D advection
(`models/advection.py`), elasticity (`models/elasticity.py`), the vortex
least-squares solve (`models/vortex.py`, entry `starterL.py`) and the RBF
advection solve, with their TPU kernels as CUDA kernels under `csrc/`, and
the sharding of fits and least-squares rows over ranks of
`torch.distributed` (`parallel/`, `--n_devices`). Entry points: `python -m
insr_pde_tpu_torch {fluid,advection,elasticity,vortex} …`; the JAX system's
yardsticks: `run_experiments` (the paper-experiment matrix), `vortex_truth`
(the f64 least-squares truth) and `vortex_sweep`.
"""

__version__ = "0.1.0"
