"""The plain reference: GATRes, its masked loss and Adam, in plain PyTorch.

Float32 with TF32 off (``precision("highest")``), in the network's own node
order, on the edge list with gathers and ``index_add``: no kernel, band,
padding or batching of the program's. It imports nothing of the program;
the benchmark hands it the same weights, readings, snapshots and masks it
hands the program, and the graph it reads itself (``network.py``).

The model, as Truong et al. (WRR 2024) and the program define GATRes::

    x = lin0(x)                                  # 1 -> C
    per block:  x0 = x
                x = relu(GAT(x; H1 heads, concat))     # C -> H1·C
                x = GAT(x; H2 heads, mean)             # H1·C -> C
                x = relu(mean_{j in N(i)} x_j + x0)
    out = lin1(x)                                # C -> 1

GAT(x)_i = sum_{j in N(i) and i} alpha_ij W x_j + b, with
alpha_ij = softmax_j(LeakyReLU_0.2(a_s . W x_j + a_d . W x_i)), one self-loop
a node (PyG GATConv). The mean divides by the in-degree.
"""

from __future__ import annotations

import contextlib
import warnings

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def precision(mode: str):
    """GEMMs in float32 (``"highest"``) or in TF32 (``"tf32"``, the control),
    and PyTorch's deterministic kernels, so that one seed reads the same in
    every run (``index_add`` sums in a fixed order, not by atomics)."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision(), torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    tf32 = mode == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    torch.set_float32_matmul_precision("high" if tf32 else "highest")
    # warn_only: cuBLAS asks for CUBLAS_WORKSPACE_CONFIG, which only a new
    # process can set; its GEMMs repeat on one card and stream all the same
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])
        torch.use_deterministic_algorithms(old[3], warn_only=old[4])


class Graph:
    """The directed edges of one network on ``device``, with self-loops for
    the attention and the in-degree for the mean."""

    def __init__(self, n: int, senders, receivers, device):
        s = torch.as_tensor(senders, dtype=torch.long, device=device)
        r = torch.as_tensor(receivers, dtype=torch.long, device=device)
        loops = torch.arange(n, device=device)
        self.n, self.src, self.dst = n, s, r
        self.src_sl, self.dst_sl = torch.cat([s, loops]), torch.cat([r, loops])
        deg = torch.zeros(n, device=device).index_add_(0, r, torch.ones_like(r, dtype=torch.float32))
        self.inv_deg = torch.where(deg > 0, 1.0 / deg.clamp(min=1.0), 0.0)


def gat(x, p: dict, pre: str, heads: int, concat: bool, g: Graph):
    """One GATConv over [b, n, F] rows."""
    b, n = x.shape[:2]
    W = p[pre + "lin.weight"]
    C = W.shape[0] // heads
    xp = (x @ W.T).view(b, n, heads, C)
    a_s = (xp * p[pre + "att_src"]).sum(-1)                      # [b, n, H]
    a_d = (xp * p[pre + "att_dst"]).sum(-1)
    e = F.leaky_relu(a_s[:, g.src_sl] + a_d[:, g.dst_sl], 0.2)    # [b, E+n, H]
    idx = g.dst_sl.view(1, -1, 1).expand(b, -1, heads)
    m = torch.full((b, n, heads), float("-inf"), device=x.device).scatter_reduce(
        1, idx, e.detach(), "amax", include_self=True)
    ex = torch.exp(e - m[:, g.dst_sl])
    z = torch.zeros(b, n, heads, device=x.device).index_add(1, g.dst_sl, ex)
    alpha = ex / z[:, g.dst_sl]
    out = torch.zeros(b, n, heads, C, device=x.device).index_add(
        1, g.dst_sl, xp[:, g.src_sl] * alpha[..., None])
    out = out.reshape(b, n, heads * C) if concat else out.mean(2)
    return out + p[pre + "bias"]


def mean_conv(x, g: Graph):
    agg = torch.zeros_like(x).index_add(1, g.dst, x[:, g.src])
    return agg * g.inv_deg[None, :, None]


def forward(p: dict, x, g: Graph, blocks: int, heads1: int, heads2: int):
    """[b, n] scaled inputs -> [b, n] scaled outputs."""
    h = x[..., None] @ p["lin0.weight"].T + p["lin0.bias"]
    for i in range(blocks):
        pre = f"blocks.{i}."
        h0 = h
        h = F.relu(gat(h, p, pre + "conv1.", heads1, True, g))
        h = gat(h, p, pre + "conv2.", heads2, False, g)
        h = F.relu(mean_conv(h, g) + h0)
    return (h @ p["lin1.weight"].T + p["lin1.bias"])[..., 0]


@torch.no_grad()
def serve(p: dict, readings, observed, mean: float, std: float, g: Graph, model: dict,
          rows: int):
    """The served fields [S, n] in metres for ``readings`` [S, k] at the
    ``observed`` node indices, ``rows`` snapshots at a time: the readings
    scaled (z-score), the hidden nodes zeroed, the output descaled, the
    observed nodes served at their readings."""
    S, n = readings.shape[0], g.n
    obs = torch.as_tensor(observed, dtype=torch.long, device=readings.device)
    out = torch.empty(S, n, device=readings.device)
    for lo in range(0, S, rows):
        r = readings[lo:lo + rows]
        x = torch.zeros(r.shape[0], n, device=r.device)
        x[:, obs] = (r - mean) / std
        out[lo:lo + rows] = forward(p, x, g, **model) * std + mean
    out[:, obs] = readings
    return out


def loss_and_grad(p: dict, x, mask, k: int, g: Graph, model: dict, rows: int):
    """The masked-MSE loss of the batch ``x`` [B, n] under ``mask`` [B, n]
    (True where a node is hidden; the hidden inputs zeroed; the squared error
    over hidden nodes divided by ``B·k``) and its gradient, summed over
    blocks of ``rows`` graphs."""
    leaves = {name: t.detach().requires_grad_(True) for name, t in p.items()}
    grads = {name: torch.zeros_like(t) for name, t in p.items()}
    loss, denom = 0.0, float(x.shape[0] * k)
    for lo in range(0, x.shape[0], rows):
        xb, mb = x[lo:lo + rows], mask[lo:lo + rows]
        out = forward(leaves, torch.where(mb, 0.0, xb), g, **model)
        part = (((out - xb) * mb) ** 2).sum() / denom
        for name, gr in zip(leaves, torch.autograd.grad(part, list(leaves.values()))):
            grads[name] += gr
        loss += float(part.detach())
    return loss, grads


def train(p0: dict, batches, k: int, g: Graph, model: dict, opt: dict, rows: int):
    """Follow ``len(batches)`` steps of :func:`loss_and_grad` and Adam (L2
    weight decay added to the gradient, as ``torch.optim.Adam`` does) from the
    weights ``p0``; each batch is ``(x, mask)``.

    Returns ``losses`` (one a step), ``grad1`` (each leaf's first gradient as
    Adam receives it, decay added) and ``params`` (the weights after the last
    step)."""
    p = {name: t.detach().clone() for name, t in p0.items()}
    m = {name: torch.zeros_like(t) for name, t in p.items()}
    v = {name: torch.zeros_like(t) for name, t in p.items()}
    b1, b2 = opt["betas"]
    losses, grad1 = [], {}
    for step, (x, mask) in enumerate(batches, start=1):
        loss, grads = loss_and_grad(p, x, mask, k, g, model, rows)
        losses.append(loss)
        with torch.no_grad():
            bc1, bc2 = 1 - b1 ** step, 1 - b2 ** step
            for name in p:
                gr = grads[name] + opt["weight_decay"] * p[name]
                if step == 1:
                    grad1[name] = gr
                m[name].mul_(b1).add_(gr, alpha=1 - b1)
                v[name].mul_(b2).addcmul_(gr, gr, value=1 - b2)
                den = (v[name].sqrt() / bc2 ** 0.5).add_(opt["eps"])
                p[name] = p[name].addcdiv(m[name], den, value=-opt["lr"] / bc1)
    return {"losses": losses, "grad1": grad1, "params": p}
