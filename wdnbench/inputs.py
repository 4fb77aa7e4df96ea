"""Everything a run feeds the program and the reference, made from ``--seed``.

A seed is any whole number, larger than 32 bits too: numpy's ``SeedSequence``
takes it with a tag for each stream, and a torch generator takes a 63-bit
draw from it. Every seed gives the same sizes (the same nodes, batches,
observed and hidden counts): only the values differ.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# stream tags: one independent stream for each kind of input
WEIGHTS, OBSERVED, READINGS, SNAPSHOTS, MASKS, SAMPLE, BASE, WARMUP = range(8)


def rng(seed: int, *tags: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % 2**64, *tags])


def torch_seed(seed: int, *tags: int) -> int:
    return int(rng(seed, *tags).integers(0, 2**63 - 1))


def param_shapes(blocks: int, channels: int, heads1: int, heads2: int) -> dict:
    """Name -> (shape, fan_in, fan_out) of each GATRes weight; ``fan_in`` None
    for a bias. The names are the layout the benchmark makes the weights in."""
    C = channels
    shapes = {"lin0.weight": ((C, 1), 1, C), "lin0.bias": ((C,), None, None)}
    for i in range(blocks):
        for conv, fin, heads, fout in (("conv1", C, heads1, heads1 * C),
                                       ("conv2", heads1 * C, heads2, C)):
            pre = f"blocks.{i}.{conv}."
            shapes[pre + "lin.weight"] = ((heads * C, fin), fin, heads * C)
            shapes[pre + "att_src"] = ((1, heads, C), heads, C)
            shapes[pre + "att_dst"] = ((1, heads, C), heads, C)
            shapes[pre + "bias"] = ((fout,), None, None)
    shapes["lin1.weight"] = ((1, C), C, 1)
    shapes["lin1.bias"] = ((1,), None, None)
    return shapes


def make_weights(shapes: dict, seed: int, device, bias_bound: float = 0.05) -> dict:
    """Glorot-uniform weights and small uniform biases, drawn on ``device`` in
    one call and cut into leaves."""
    gen = torch.Generator(device=device).manual_seed(torch_seed(seed, WEIGHTS))
    total = sum(math.prod(s) for s, _, _ in shapes.values())
    u = torch.rand(total, generator=gen, device=device) * 2.0 - 1.0
    out, at = {}, 0
    for name, (shape, fin, fout) in shapes.items():
        k = math.prod(shape)
        bound = bias_bound if fin is None else math.sqrt(6.0 / (fin + fout))
        out[name] = (u[at:at + k] * bound).view(shape).clone()
        at += k
    return out


def observed_nodes(seed: int, n: int, k: int) -> np.ndarray:
    """The ``k`` sensor nodes of a run, sorted."""
    return np.sort(rng(seed, OBSERVED).choice(n, size=k, replace=False))


def reading_batch(seed: int, index: int, rows: int, base: np.ndarray,
                  std_m: float, stream: int = READINGS) -> np.ndarray:
    """Request ``index``'s readings [rows, k] in metres, float32: each
    sensor's base pressure plus a swing shared by the snapshot and a
    deviation of its own."""
    r = rng(seed, stream, index)
    swing = r.standard_normal((rows, 1)) * (0.8 * std_m)
    own = r.standard_normal((rows, base.shape[0])) * (0.6 * std_m)
    return (base[None, :] + swing + own).astype(np.float32)


def sensor_base(seed: int, k: int, mean_m: float, std_m: float) -> np.ndarray:
    return (mean_m + 0.5 * std_m * rng(seed, BASE).standard_normal(k)).astype(np.float32)


def snapshot_pool(seed: int, rows: int, n: int) -> np.ndarray:
    """``rows`` scaled snapshots [rows, n], float32, all different."""
    r = rng(seed, SNAPSHOTS)
    swing = r.standard_normal((rows, 1), dtype=np.float32)
    return swing + 0.5 * r.standard_normal((rows, n), dtype=np.float32)


def mask_pool(seed: int, masks: int, batch: int, n: int, hidden: int) -> np.ndarray:
    """``masks`` hidden-node masks [masks, batch·n] bool, each graph with
    exactly ``hidden`` nodes hidden."""
    r = rng(seed, MASKS)
    keep = n - hidden
    u = r.random((masks * batch, n), dtype=np.float32)
    shown = np.argpartition(u, keep - 1, axis=1)[:, :keep]
    m = np.ones((masks * batch, n), bool)
    np.put_along_axis(m, shown, False, axis=1)
    return m.reshape(masks, batch * n)


def sample(seed: int, population: int, k: int) -> np.ndarray:
    """``k`` (or all, if fewer) of ``range(population)``, sorted."""
    k = min(k, population)
    return np.sort(rng(seed, SAMPLE).choice(population, size=k, replace=False))
