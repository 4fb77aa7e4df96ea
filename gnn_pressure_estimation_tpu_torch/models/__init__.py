from gnn_pressure_estimation_tpu_torch.models.gatres import GATRes, GATResBlock
from gnn_pressure_estimation_tpu_torch.models.zoo import GIN, GAT, GCN2, ChebNet, GraphConvWat, MGCN
from gnn_pressure_estimation_tpu_torch.models.remask import GATResRemask, GATResRemaskStack
from gnn_pressure_estimation_tpu_torch.models.presets import MODEL_REGISTRY, select_model

__all__ = [
    "GATRes",
    "GATResBlock",
    "GIN",
    "GAT",
    "GCN2",
    "ChebNet",
    "GraphConvWat",
    "MGCN",
    "GATResRemask",
    "GATResRemaskStack",
    "MODEL_REGISTRY",
    "select_model",
]
