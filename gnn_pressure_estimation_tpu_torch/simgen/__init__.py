from gnn_pressure_estimation_tpu_torch.simgen.units import FLOW_UNITS, flow_to_cfs, convert_result
from gnn_pressure_estimation_tpu_torch.simgen.network_state import NetworkState
from gnn_pressure_estimation_tpu_torch.simgen.solver_api import solve, SolverResult

__all__ = [
    "FLOW_UNITS",
    "flow_to_cfs",
    "convert_result",
    "NetworkState",
    "solve",
    "SolverResult",
]
