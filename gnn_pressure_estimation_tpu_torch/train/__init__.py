from gnn_pressure_estimation_tpu_torch.train.autoclip import AutoClip
from gnn_pressure_estimation_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from gnn_pressure_estimation_tpu_torch.train.early_stopping import EarlyStopping
from gnn_pressure_estimation_tpu_torch.train.loop import TrainConfig, Trainer

__all__ = [
    "AutoClip",
    "EarlyStopping",
    "TrainConfig",
    "Trainer",
    "load_checkpoint",
    "save_checkpoint",
]
