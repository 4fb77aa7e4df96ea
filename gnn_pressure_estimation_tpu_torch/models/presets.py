"""Model presets — name → (constructor, training-config contract).

The counterpart of ``gnn_pressure_estimation_tpu/models/presets.py``: the
eight names of the JAX registry, GATRes-small and -large and the baseline
zoo, each with its criterion, normalisation and edge attributes.
``apply_model_knobs`` sets the attention knobs (``attn_impl``,
``attn_dtype``, ``gate_dtype``) on a built model, as the JAX CLI does, and
raises where the JAX function raises: on a model without the knob.
``select_model(..., dtype=)`` sets the activation dtype of a model that has
the knob (GATRes) and raises on the others, as the JAX function does.
"""

from __future__ import annotations

import dataclasses
import functools
import inspect
from typing import Callable, Optional

import torch
from torch import nn

from gnn_pressure_estimation_tpu_torch.device import resolve_device
from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes
from gnn_pressure_estimation_tpu_torch.models.layers import ATTN_IMPLS, check_dtype_knob
from gnn_pressure_estimation_tpu_torch.models.zoo import GAT, GCN2, GIN, MGCN, ChebNet, GraphConvWat


@dataclasses.dataclass(frozen=True)
class ModelPreset:
    name: str
    build: Callable[..., nn.Module]   # the model class at the preset's hyperparameters
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
        "gatres_small",
        functools.partial(GATRes, num_blocks=15, channels=32, attn_impl="factored"),
        criterion="mse", norm_type="znorm",
    ),
    "gatres_large": ModelPreset(
        "gatres_large",
        functools.partial(GATRes, num_blocks=25, channels=128, attn_impl="factored"),
        criterion="mse", norm_type="znorm",
    ),
    "gin": ModelPreset(
        "gin", functools.partial(GIN, num_blocks=15, channels=32),
        criterion="mse", norm_type="znorm",
    ),
    "graphconvwat": ModelPreset(
        "graphconvwat", functools.partial(GraphConvWat), criterion="mse", norm_type="minmax",
    ),
    "chebnet": ModelPreset(
        "chebnet", functools.partial(ChebNet, channels=32), criterion="mse", norm_type="znorm",
    ),
    # edge_dim is the number of edge attributes, which the JAX model reads
    # off the graph at init: select_model(..., edge_dim=) sets it
    "mgcn": ModelPreset(
        "mgcn",
        functools.partial(MGCN, latent_dim=96, n_aggr=45, n_hops=1, num_layers=2, edge_dim=2),
        criterion="mae", norm_type="minmax", edge_attrs=("diameter", "length"),
    ),
    "gcn2": ModelPreset(
        "gcn2", functools.partial(GCN2, num_blocks=64, channels=32),
        criterion="mse", norm_type="znorm",
    ),
    "gat": ModelPreset(
        "gat", functools.partial(GAT, num_blocks=10, channels=32),
        criterion="mse", norm_type="znorm",
    ),
}


def apply_model_knobs(model: nn.Module, attn_impl=None, gate_dtype=None,
                      attn_dtype=None) -> nn.Module:
    """Set attention-knob overrides on ``model`` and every layer of it that
    has the knob, after checking that the model exposes each one; the
    counterpart of the JAX package's ``apply_model_knobs``. Dtype knobs take
    the CLI strings ``'float32'`` / ``'bfloat16'`` or torch dtypes; None leaves
    the preset's value. The JAX function returns a clone; a torch module
    carries its weights, so the knobs are set in place and ``model`` is
    returned."""
    def _dt(v):
        if v is None or not isinstance(v, str):
            return v
        if v == "float32":
            return torch.float32
        if v == "bfloat16":
            return torch.bfloat16
        raise ValueError(f"dtype knob must be 'float32' or 'bfloat16', got {v!r}")

    overrides = {}
    for knob, val in (("attn_impl", attn_impl), ("gate_dtype", _dt(gate_dtype)),
                      ("attn_dtype", _dt(attn_dtype))):
        if val is None:
            continue
        if not hasattr(model, knob):
            raise ValueError(f"model {type(model).__name__} has no {knob!r} knob")
        if knob == "attn_impl" and val not in ATTN_IMPLS:
            raise NotImplementedError(f"attn_impl {val!r} is not one of {ATTN_IMPLS}")
        overrides[knob] = val if knob == "attn_impl" else check_dtype_knob(knob, val)
    for module in model.modules():
        for knob, val in overrides.items():
            if hasattr(module, knob):
                setattr(module, knob, val)
    return model


def check_dtype_knob_of(name: str) -> None:
    """Raise the JAX function's ``ValueError`` when the preset ``name`` has no
    activation-dtype knob (every model but GATRes)."""
    if "dtype" not in inspect.signature(MODEL_REGISTRY[name].build).parameters:
        raise ValueError(f"model '{name}' has no activation-dtype knob")


def select_model(name: str, device="cuda", seed: int = 0,
                 edge_dim: Optional[int] = None, dtype=None) -> tuple[nn.Module, ModelPreset]:
    """The preset's model with its weights drawn from ``seed`` as the JAX
    layers draw them, on ``device`` (raises if that is CUDA and no card is
    present). ``edge_dim``, for a preset with edge attributes (m_GCN), is
    the number of attributes the data carries, which the JAX model reads
    off the graph; None keeps the preset's. ``dtype`` (None, or a torch
    dtype: ``torch.bfloat16``) is the activation dtype of a model that has
    the knob (GATRes; ``ValueError`` on the others, as in the JAX
    function); it changes no parameter."""
    dev = resolve_device(device)
    if name not in MODEL_REGISTRY:
        raise KeyError(f"unknown model '{name}'; available: {sorted(MODEL_REGISTRY)}")
    preset = MODEL_REGISTRY[name]
    extra = {} if edge_dim is None else {"edge_dim": edge_dim}
    if edge_dim is not None and preset.edge_attrs is None:
        raise ValueError(f"model '{name}' reads no edge attributes; edge_dim does not apply")
    if dtype is not None:
        check_dtype_knob_of(name)
        extra["dtype"] = check_dtype_knob("dtype", dtype)
    model = preset.build(**extra)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    return model.to(dev), preset
