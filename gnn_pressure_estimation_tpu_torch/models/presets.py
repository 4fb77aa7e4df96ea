"""Model presets — name → (constructor, training-config contract).

The counterpart of ``gnn_pressure_estimation_tpu/models/presets.py``. Only
the GATRes presets are ported; the other names of the JAX registry raise.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch import nn

from gnn_pressure_estimation_tpu_torch.device import resolve_device
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes

NOT_YET_PORTED = ("gin", "graphconvwat", "chebnet", "mgcn", "gcn2", "gat")


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    build: Callable[[], nn.Module]
    criterion: str = "mse"          # mse | mae | sce
    norm_type: str = "znorm"        # znorm | minmax | unused
    edge_attrs: Optional[tuple] = None

    def make(self) -> nn.Module:
        return self.build()

    def train_config(self, **overrides):
        """A ``TrainConfig`` with this preset's criterion and normalization,
        as the JAX CLI's ``train`` fills them where no flag overrides."""
        from gnn_pressure_estimation_tpu_torch.train.loop import TrainConfig

        return TrainConfig(**{"criterion": self.criterion, "norm_type": self.norm_type,
                              "model_name": self.name, **overrides})


MODEL_REGISTRY: dict[str, ModelPreset] = {
    # attn_impl="factored" selects the factored dense rewrite; the banded
    # path runs the windowed softmax either way, through the kernel the graph
    # names (train_config(band_attn=..., band_block=...) passes the choice on)
    "gatres_small": ModelPreset(
        "gatres_small", lambda: GATRes(num_blocks=15, channels=32, attn_impl="factored"),
        criterion="mse", norm_type="znorm",
    ),
    "gatres_large": ModelPreset(
        "gatres_large", lambda: GATRes(num_blocks=25, channels=128, attn_impl="factored"),
        criterion="mse", norm_type="znorm",
    ),
}


def select_model(name: str, device="cuda", seed: int = 0) -> tuple[nn.Module, ModelPreset]:
    """The preset's model with glorot weights drawn from ``seed``, on
    ``device`` (raises if that is CUDA and no card is present)."""
    dev = resolve_device(device)
    if name in NOT_YET_PORTED:
        raise NotImplementedError(f"model '{name}' is not yet ported")
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}")
    preset = MODEL_REGISTRY[name]
    model = preset.make()
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev), preset
