"""Carry weights across from the JAX package: GATRes, the model zoo and the
remask variants.

``params_from_flax`` maps a JAX/Flax parameter tree, given as nested dicts
of arrays (``params["params"]["block_i"]["GATConv_0"]["w"]`` …), onto the
``state_dict`` of a port model of the same structure; ``params_to_flax`` is
its inverse. Both read :func:`flax_names`, the one table of each model:
every module class states in ``FLAX_NAMES`` the flax name of each part
whose name differs (``{"blocks": "block_{}"}``, ``{"conv1": "GATConv_0"}``,
``{"convs": "GINConv_{}"}``, ``{"lin.weight": "w"}`` …), and an
``nn.Linear`` is a flax ``Dense``, its ``weight`` [out, in] the ``kernel``
[in, out] transposed. ``params_from_parity_npz`` maps the torch-layout
GATRes parity fixtures that ``tools/parity_export.py`` writes (``w_lin0``,
``blk{i}_conv{j}_lin_w`` …). Any tree of the parameters' structure maps the
same way, so gradients and Adam moments cross too: ``adam_state_from_optax``
turns optax's ``mu``/``nu``/``count`` into the ``state`` of
``torch.optim.Adam.state_dict()``. None of this needs JAX: the arrays are
read through numpy.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def flax_names(model: nn.Module) -> dict[str, tuple[tuple[str, ...], bool]]:
    """Each ``state_dict`` key of ``model``, in ``named_parameters()`` order,
    → (its flax parameter path, whether the array is transposed), from the
    ``FLAX_NAMES`` table of each module on the way: a child's flax name (a
    ModuleList's ``"{}"`` takes the index), a parameter's, or, keyed
    ``"<child>.weight"``, the flax leaf that a bias-free projection child
    is. Names not in a table are the same in flax."""
    out = {}

    def walk(mod: nn.Module, port: str, flax: tuple):
        table = getattr(mod, "FLAX_NAMES", {})
        dense = isinstance(mod, nn.Linear)
        for name, _ in mod.named_parameters(recurse=False):
            kernel = dense and name == "weight"
            out[port + name] = (flax + ("kernel" if kernel else table.get(name, name),), kernel)
        for name, child in mod.named_children():
            if name + ".weight" in table:
                out[f"{port}{name}.weight"] = (flax + (table[name + ".weight"],), True)
            elif isinstance(child, nn.ModuleList):
                for i, c in enumerate(child):
                    walk(c, f"{port}{name}.{i}.", flax + (table[name].format(i),))
            else:
                walk(child, f"{port}{name}.", flax + (table.get(name, name),))

    walk(model, "", ())
    return out


def params_from_flax(tree, model: nn.Module) -> dict[str, torch.Tensor]:
    """A flax parameter tree (or any tree of its structure) → ``model``'s
    ``state_dict``, of the leaves present; raises on a leaf the model does
    not have."""
    p = tree["params"] if "params" in tree else tree
    leaves = dict(_leaves(p))
    sd = {}
    for key, (path, transpose) in flax_names(model).items():
        if path in leaves:
            a = leaves.pop(path)
            sd[key] = _t(np.asarray(a).T if transpose else a)
    if leaves:
        raise ValueError(f"{type(model).__name__} has no parameter for the flax leaves "
                         f"{sorted('/'.join(k) for k in leaves)[:4]}")
    return sd


def params_from_fixture(fx, model: nn.Module, prefix: str = "param") -> dict[str, torch.Tensor]:
    """A fixture that stores a flax tree flat, one array per
    ``<prefix>/<flax path>`` key (``tools/parity_zoo_export.py``: ``param``,
    ``grad``, ``p3``), → ``model``'s ``state_dict`` (of the keys present)."""
    tree: dict = {}
    for key in fx.files if hasattr(fx, "files") else fx:
        if not key.startswith(prefix + "/"):
            continue
        *mods, leaf = key[len(prefix) + 1:].split("/")
        node = tree
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = np.asarray(fx[key])
    return params_from_flax(tree, model)


def params_from_parity_npz(path) -> dict[str, torch.Tensor]:
    with np.load(path) as d:
        sd = {
            "lin0.weight": _t(d["w_lin0"]), "lin0.bias": _t(d["b_lin0"]),
            "lin1.weight": _t(d["w_lin1"]), "lin1.bias": _t(d["b_lin1"]),
        }
        for i in range(int(d["num_blocks"])):
            for j in (1, 2):
                src, pre = f"blk{i}_conv{j}", f"blocks.{i}.conv{j}"
                sd[f"{pre}.lin.weight"] = _t(d[f"{src}_lin_w"])
                sd[f"{pre}.att_src"] = _t(d[f"{src}_att_src"])
                sd[f"{pre}.att_dst"] = _t(d[f"{src}_att_dst"])
                sd[f"{pre}.bias"] = _t(d[f"{src}_bias"])
    return sd


def params_to_flax(state_dict, model: nn.Module) -> dict:
    """The inverse of :func:`params_from_flax`: a ``state_dict`` of
    ``model`` (or any dict of that structure) → ``{"params": nested dicts of
    numpy arrays}``."""
    names = flax_names(model)
    p: dict = {}
    for key, v in state_dict.items():
        path, transpose = names[key]
        a = np.array(torch.as_tensor(v).detach().cpu().numpy(), copy=True)
        node = p
        for m in path[:-1]:
            node = node.setdefault(m, {})
        node[path[-1]] = a.T if transpose else a
    return {"params": p}


def adam_state_from_optax(mu_tree, nu_tree, count, model: nn.Module) -> dict[int, dict]:
    """optax ``ScaleByAdamState`` (``mu``, ``nu`` as nested dicts of arrays,
    ``count``) → the ``state`` part of ``torch.optim.Adam.state_dict()`` for
    ``model``, indexed in its ``named_parameters()`` order."""
    mu, nu = params_from_flax(mu_tree, model), params_from_flax(nu_tree, model)
    return {
        i: {"step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": mu[name], "exp_avg_sq": nu[name]}
        for i, (name, _) in enumerate(model.named_parameters())
    }
