from gnn_pressure_estimation_tpu_torch.evaluation.harness import (
    EvalConfig,
    Evaluator,
    evaluate,
)
from gnn_pressure_estimation_tpu_torch.evaluation.timer import Timer
from gnn_pressure_estimation_tpu_torch.evaluation.sensors import get_sensors

__all__ = ["EvalConfig", "Evaluator", "evaluate", "Timer", "get_sensors"]
