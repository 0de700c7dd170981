"""Device and dtype policy (the port's counterpart of `insr_pde_tpu/ops/precision.py`).

Everything runs in float32 with TF32 off: second derivatives of sin(30x)
amplify rounding about 30x per derivative order (`models/networks.py` of the
JAX package), so a 10-bit-mantissa product is not acceptable on the
derivative chains. `--matmul_precision` is accepted for CLI parity, but every
level runs full f32 until TF32 has been measured on the Taylor–Green golden.
"""

from __future__ import annotations

import torch


def set_full_precision() -> None:
    """Turn TF32 off for matmuls and cuDNN (cuDNN's default is on)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def resolve_device(name: str) -> torch.device:
    """The device named by `cfg.device`. "cuda" without a card raises: the
    port never falls back to the CPU on its own."""
    if name == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass --device cpu to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    if name == "cpu":
        return torch.device("cpu")
    raise ValueError(f"device must be 'cuda' or 'cpu', got {name!r}")
