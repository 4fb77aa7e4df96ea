"""The matmul precision of the training steps.

The counterpart of the JAX package's ``Trainer._with_precision``
(``train/loop.py``), which runs the jitted train and eval steps under
``jax.default_matmul_precision(cfg.matmul_precision)``: here
:func:`matmul_precision` scopes the GEMMs of one step, and the process's
setting comes back after it.

The names are the JAX package's. ``"highest"``: f32 GEMMs. ``"tensorfloat32"``:
TF32 on the card (``torch.set_float32_matmul_precision("high")``); the CPU
computes f32, as XLA on the CPU does for every name. ``"bfloat16"``: both
operands rounded to bfloat16 and the products summed in f32, what the name
means on the TPU. torch's own ``"medium"`` gives that product on the CPU but
TF32 through cuBLAS on an H100, so the rounding is explicit
(:class:`Bf16Operands`), the same on both devices. The hand-written kernels
are not GEMMs of this kind: they compute in f32 at every setting.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

MATMUL_PRECISIONS = (None, "highest", "tensorfloat32", "bfloat16")


class Bf16Operands(TorchDispatchMode):
    """Every f32 GEMM (mm, addmm, bmm, baddbmm, mv, addmv, dot, linear)
    computed from its two operands rounded to bfloat16 (ties to even), the
    products summed in f32: what the name means on the TPU. The rounding is
    explicit, so the result does not hang on a library's reduced-precision
    paths; the backward's GEMMs are rounded too. The hand-written kernels
    are not GEMMs of this kind and compute in f32."""

    _OPERANDS = {"mm": (0, 1), "addmm": (1, 2), "bmm": (0, 1), "baddbmm": (1, 2), "mv": (0, 1),
                 "addmv": (1, 2), "dot": (0, 1), "_addmm_activation": (1, 2), "linear": (0, 1)}
    OPS = {getattr(torch.ops.aten, name).default: idx for name, idx in _OPERANDS.items()}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        idx = self.OPS.get(func)
        if idx is not None:
            args = list(args)
            for i in idx:
                if isinstance(args[i], torch.Tensor) and args[i].dtype == torch.float32:
                    args[i] = args[i].to(torch.bfloat16).to(torch.float32)
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def matmul_precision(precision: Optional[str]):
    """The GEMMs inside the block at ``precision``, the JAX package's
    ``default_matmul_precision`` names: None leaves the process's setting;
    ``"highest"`` f32 (``torch.set_float32_matmul_precision("highest")``);
    ``"tensorfloat32"`` TF32 on the card (``"high"``; the CPU computes f32,
    as XLA on the CPU does); ``"bfloat16"`` bf16-rounded operands with f32
    sums (:class:`Bf16Operands` under ``"highest"``). The previous setting is
    restored on exit."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"matmul_precision {precision!r} is not one of {MATMUL_PRECISIONS}")
    if precision is None:
        yield
        return
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high" if precision == "tensorfloat32" else "highest")
    try:
        if precision == "bfloat16":
            with Bf16Operands():
                yield
        else:
            yield
    finally:
        torch.set_float32_matmul_precision(before)
