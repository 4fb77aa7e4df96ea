from gnn_pressure_estimation_tpu_torch.data.zarrzip import ZarrZipWriter, ZarrZipReader
from gnn_pressure_estimation_tpu_torch.data.inp import WaterNetwork, parse_inp
from gnn_pressure_estimation_tpu_torch.data.dataset import WDNDataset, SnapshotLoader

__all__ = [
    "ZarrZipWriter",
    "ZarrZipReader",
    "WaterNetwork",
    "parse_inp",
    "WDNDataset",
    "SnapshotLoader",
]
