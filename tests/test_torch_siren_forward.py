"""PyTorch port, the fused SIREN forward module (`ops/siren_forward.py`).

On the CPU the wrapper runs its plain version, which is held against the
JAX kernel run in interpret mode (as tests/test_pallas_siren.py runs it)
and against `_forward_reference`, at the JAX pins (300x2 at width 32 with 3
hidden layers; 517x3 at width 20 with 2 hidden layers and out 1) with atol
2e-5. The gradient of the autograd.Function matches jax.grad of
`_forward_reference`. The CUDA kernel itself runs only on the card: its
case is marked `cuda` and skips here. Its source's logic (the row plan and
tile walk, both rows-per-thread instantiations, the resident weights and
the two-layer ring, the ragged last tile) is also checked on the CPU, built
with the host C++ compiler against the emulation of the CUDA runtime of
`tests/test_torch_siren_vgl.py`."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from insr_pde_tpu.models.networks import MLP as JMLP
from insr_pde_tpu.ops.pallas_siren import (_forward_reference,
                                           siren_forward_interpret)
from insr_pde_tpu_torch.convert import params_from_jax
from insr_pde_tpu_torch.models.networks import MLP
from insr_pde_tpu_torch.ops.siren_forward import (pack_params, siren_forward,
                                                  siren_forward_reference)
from test_torch_siren_vgl import host_build

torch.set_num_threads(1)

PINS = [  # (in, out, hidden layers, width, N, seed)
    (2, 2, 3, 32, 300, 0),
    (3, 1, 2, 20, 517, 2),
]


def _case(in_f, out_f, layers, width, n, seed):
    jp = JMLP(in_f, out_f, layers, width).init(jax.random.PRNGKey(seed))
    x = np.random.default_rng(seed).uniform(-1, 1, (n, in_f)).astype(np.float32)
    return jp, params_from_jax([(np.asarray(w), np.asarray(b)) for w, b in jp]), x


@pytest.mark.parametrize("pin", PINS)
def test_plain_version_matches_pallas_interpret_and_reference(pin):
    jp, tp, x = _case(*pin)
    got = siren_forward_reference(tp, torch.from_numpy(x)).numpy()
    ref = np.asarray(_forward_reference(jp, jnp.asarray(x)))
    interp = np.asarray(siren_forward_interpret(jp, jnp.asarray(x)))
    assert got.shape == (pin[4], pin[1])
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(got, interp, atol=2e-5)


@pytest.mark.parametrize("pin", PINS)
def test_gradient_matches_jax(pin):
    """The autograd.Function's backward recomputes through the plain
    version; it equals jax.grad of _forward_reference (params and coords)."""
    jp, tp, x = _case(*pin)
    cot = np.random.default_rng(7).normal(size=(pin[4], pin[1])).astype(
        np.float32)

    def jloss(p, xx):
        return jnp.sum(_forward_reference(p, xx) * cot)

    jg_p, jg_x = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    leaves = [t.requires_grad_(True) for wb in tp for t in wb]
    torch.sum(siren_forward(tp, xt) * torch.from_numpy(cot)).backward()
    for jl, tl in zip(jax.tree_util.tree_leaves(jg_p) + [jg_x],
                      leaves + [xt]):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.grad.numpy(), jl, rtol=1e-4,
                                   atol=1e-4 * np.abs(jl).max())


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    _, tp, x = _case(*PINS[0])
    before = siren_forward.launches
    out = siren_forward(tp, torch.from_numpy(x))
    assert siren_forward.launches == before
    np.testing.assert_array_equal(
        out.numpy(), siren_forward_reference(tp, torch.from_numpy(x)).numpy())
    # apply_fused reaches the same wrapper, any leading shape
    net = MLP(2, 2, 3, 32)
    grid = torch.from_numpy(x[:299]).reshape(13, 23, 2)
    np.testing.assert_array_equal(net.apply_fused(tp, grid).numpy(),
                                  net.apply(tp, grid).numpy())
    assert siren_forward.launches == before


def test_wrapper_rejects_what_the_kernel_does_not_take():
    _, tp, x = _case(*PINS[0])
    xt = torch.from_numpy(x)
    with pytest.raises(TypeError):
        siren_forward(tp, xt.double())
    with pytest.raises(ValueError):
        siren_forward(tp, xt.t())                       # not contiguous
    with pytest.raises(ValueError):
        siren_forward(tp, xt[:, :1].contiguous())       # in_dim mismatch
    wide = MLP(2, 2, 1, 129).init(torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="128"):
        siren_forward(wide, xt)
    with pytest.raises(ValueError):
        siren_forward([], xt)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card and nvcc: the CUDA kernel has no "
                    "CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(300, 2, 2, 3, 32), (517, 3, 1, 2, 20),
                                   (16384, 2, 2, 3, 32),
                                   (4099, 2, 2, 5, 128)])
def test_kernel_matches_plain_version_on_card(cuda_device, shape):
    n, in_f, out_f, layers, width = shape
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=cuda_device).manual_seed(0)
    params = MLP(in_f, out_f, layers, width).init(g)
    x = torch.rand((n, in_f), generator=g, device=cuda_device) * 2 - 1
    before = siren_forward.launches
    out = siren_forward(params, x)
    torch.cuda.synchronize()
    assert siren_forward.launches == before + 1
    ref = siren_forward_reference(params, x)
    # 2e-5: the JAX pins' tolerance; width 128: 5e-5 (chip_smoke.py)
    atol = 5e-5 if width > 32 else 2e-5
    assert (out - ref).abs().max().item() <= atol


@pytest.fixture(scope="module")
def emulated_library(tmp_path_factory):
    lib = host_build("siren_forward", tmp_path_factory.mktemp("emu_siren"))
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.siren_forward_f32.argtypes = [p, p, p, i, i, p, ctypes.c_float, p]
    return lib


@pytest.mark.parametrize("shape", [
    (300, 2, 2, 3, 32),     # the fluid net: a row a thread, 5 tiles of 64
    (517, 3, 1, 2, 20),     # the JAX pin, out 1
    (33, 2, 1, 1, 2),       # width 2
    (1000, 2, 1, 2, 64),    # a row a thread, 32 tiles of 32
    (300, 2, 1, 2, 128),    # 8 rows a thread, every layer resident
    (300, 2, 2, 5, 128),    # 8 rows a thread, the ring over 7 layers
])
def test_cuda_source_matches_plain_version_in_host_emulation(
        emulated_library, shape):
    """The kernel's code, run by host threads, against the plain version:
    2e-5 (the JAX pins), 5e-5 past width 32 (chip_smoke.py). N is no
    multiple of the tile, and the rows spread over the blocks of 2 SMs take
    more tiles than blocks, so a block walks several (and the ring wraps
    from tile to tile; at width 128, 3 tiles of 128 rows); a second run
    gives the same bits."""
    n, in_f, out_f, layers, width = shape
    g = torch.Generator().manual_seed(3)
    params = MLP(in_f, out_f, layers, width).init(g)
    x = torch.rand((n, in_f), generator=g) * 2 - 1
    packed, widths = pack_params(params)
    c_widths = (ctypes.c_int * len(widths))(*widths)

    def run():
        out = torch.full((n, out_f), float("nan"))
        assert emulated_library.siren_forward_f32(
            x.data_ptr(), packed.data_ptr(), out.data_ptr(), n, len(params),
            c_widths, 30.0, None) == 0
        return out

    out = run()
    atol = 5e-5 if width > 32 else 2e-5
    assert (out - siren_forward_reference(params, x)).abs().max().item() \
        <= atol
    assert torch.equal(run(), out)


def test_library_hash_covers_the_included_header(tmp_path, monkeypatch):
    """A source's library is keyed on the source with its `csrc/` headers
    inlined: an edit of the shared engine header rebuilds both forwards."""
    from insr_pde_tpu_torch.ops import cuda_build
    for f in cuda_build.CSRC.iterdir():
        (tmp_path / f.name).write_text(f.read_text())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    before = {n: cuda_build.library_path(n)
              for n in ("siren_forward", "siren_vgl", "block_ell")}
    header = tmp_path / "sine_mlp_tile.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in before}
    assert after["siren_forward"] != before["siren_forward"]
    assert after["siren_vgl"] != before["siren_vgl"]
    assert after["block_ell"] == before["block_ell"]
    assert "// edited" in cuda_build.source_text("siren_forward")
