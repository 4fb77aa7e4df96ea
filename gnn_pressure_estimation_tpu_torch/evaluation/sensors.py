"""Sensor lookup — optional secrets plug-in (reference evaluation.py:27-66).

The reference reads real Oosterbeek sensor ids from an uncommitted
``utils/mysecrets.py`` and degrades to an empty list otherwise. Same contract
here: an optional ``mysecrets.py`` importable on sys.path exposing
``secrets = {"<NETWORK>_NODE_SENSORS": [...], "<NETWORK>_LINK_SENSORS": [...]}``
keyed by the upper-cased INP basename; plus explicit sensor lists can be
passed through EvalConfig directly.

A copy of ``gnn_pressure_estimation_tpu/evaluation/sensors.py`` (numpy only).
"""

from __future__ import annotations

import os
from typing import Optional, Sequence

from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp


def get_sensors(
    test_input_path: str,
    feature: str = "pressure",
    include_reservoir: bool = False,
    sensor_names: Optional[Sequence[str]] = None,
) -> tuple[list[int], list[str]]:
    """Returns (indices into the canonical node/link order, names).
    Empty lists when no sensors are configured (degrades like the
    reference)."""
    wn = parse_inp(test_input_path)

    if sensor_names is None:
        net = os.path.splitext(os.path.basename(test_input_path))[0].upper()
        try:
            from mysecrets import secrets  # optional, uncommitted
        except ImportError:
            print(
                "Warning! Secrets are not found! Sensors are unavailable! "
                "The results will be similar to all cases!"
            )
            return [], []
        key = f"{net}_NODE_SENSORS" if feature in ("pressure", "head") else f"{net}_LINK_SENSORS"
        if key not in secrets:
            print(f"ERROR! Sensors for {net} not found in secrets!")
            return [], []
        sensor_names = secrets[key]
        if feature not in ("pressure", "head") and not include_reservoir:
            sensor_names = sensor_names[:-3]

    names = wn.node_names if feature in ("pressure", "head") else wn.link_names
    lookup = {n: i for i, n in enumerate(names)}
    idx = [lookup[s] for s in sensor_names if s in lookup]
    found = [s for s in sensor_names if s in lookup]
    return idx, found
