"""PyTorch port: GATConv's attention logit halves (``ops/gat_logits.py``,
``csrc/gat_logits.cu``). A CUDA kernel cannot run here, so the plain versions
are held against the layer's own expression and autograd of it, the kernels'
index arithmetic (the forward's lane groups and butterfly, the backward's
column tiles, row groups, chunks and the fold over 32 stripes) is replayed in
numpy and held against the plain versions, and ``GATConv`` on the CPU is held
to the numbers it gave before the kernels, bit for bit."""

import numpy as np
import pytest
import torch

from gnn_pressure_estimation_tpu_torch.core.graph import GraphTemplate
from gnn_pressure_estimation_tpu_torch.models import layers
from gnn_pressure_estimation_tpu_torch.models.layers import GATConv
from gnn_pressure_estimation_tpu_torch.ops import gat_logits as gl

torch.set_num_threads(1)
# (H, C): GATRes-large's conv1 and conv2, the zoo's GAT at H 2 C 32 and H 1 C 1
WIDTHS = [(2, 128), (1, 128), (2, 32), (1, 1)]
THREADS, ROWS_PER_GROUP, STRIPES = 256, 16, 32      # csrc/gat_logits.cu's constants


def _operands(H, C, N=203, seed=0):
    g = torch.Generator().manual_seed(seed + 97 * H + C)
    xp = torch.randn(N, H, C, generator=g)
    att_src, att_dst = torch.randn(1, H, C, generator=g), torch.randn(1, H, C, generator=g)
    cot = (torch.randn(N, H, C, generator=g), torch.randn(N, H, generator=g),
           torch.randn(N, H, generator=g))
    return xp, att_src, att_dst, cot


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


def _todays_grads(xp, att_src, att_dst, cot):
    """Autograd of the layer's expression before the kernels, with xp also
    an output (its cotangent ``cot[0]``): (d xp, d att_src, d att_dst)."""
    xp, att_src, att_dst = (t.clone().requires_grad_() for t in (xp, att_src, att_dst))
    a_s, a_d = (xp * att_src).sum(-1), (xp * att_dst).sum(-1)
    loss = (xp * cot[0]).sum() + (a_s * cot[1]).sum() + (a_d * cot[2]).sum()
    return torch.autograd.grad(loss, (xp, att_src, att_dst))


@pytest.mark.parametrize("H,C", WIDTHS)
def test_plain_forward_is_the_layer_expression(H, C):
    xp, att_src, att_dst, _ = _operands(H, C)
    a_s, a_d = gl.gat_logits_plain(xp, att_src, att_dst)
    assert torch.equal(a_s, (xp * att_src).sum(-1))
    assert torch.equal(a_d, (xp * att_dst).sum(-1))
    assert a_s.shape == a_d.shape == (xp.shape[0], H)


@pytest.mark.parametrize("H,C", WIDTHS)
def test_plain_backward_matches_autograd(H, C):
    xp, att_src, att_dst, cot = _operands(H, C)
    got = gl.gat_logits_bwd_plain(xp, att_src, att_dst, *cot)
    for name, g, r in zip(("d xp", "d att_src", "d att_dst"), got,
                          _todays_grads(xp, att_src, att_dst, cot)):
        assert g.shape == r.shape, name
        assert _rel(g, r) <= 1e-6, name


@pytest.mark.parametrize("H,C", WIDTHS)
def test_function_on_the_cpu(H, C):
    """``GatLogits`` on CPU tensors: xp passed through, the halves and the
    gradients the plain versions'."""
    xp, att_src, att_dst, cot = _operands(H, C)
    leaves = [t.clone().requires_grad_() for t in (xp, att_src, att_dst)]
    xp_out, a_s, a_d = gl.GatLogits.apply(*leaves)
    assert torch.equal(xp_out, xp)
    ref = gl.gat_logits_plain(xp, att_src, att_dst)
    assert torch.equal(a_s, ref[0]) and torch.equal(a_d, ref[1])
    loss = (xp_out * cot[0]).sum() + (a_s * cot[1]).sum() + (a_d * cot[2]).sum()
    got = torch.autograd.grad(loss, leaves)
    for g, r in zip(got, gl.gat_logits_bwd_plain(xp, att_src, att_dst, *cot)):
        assert torch.equal(g, r)


def _bad_operands(case):
    xp, att_src, att_dst, _ = _operands(2, 32, N=16)
    if case == "f64":
        xp = xp.double()
    elif case == "shape":
        att_src = att_src[:, :, :16].contiguous()
    elif case == "strided":
        xp = xp.transpose(0, 1).contiguous().transpose(0, 1)
    return xp, att_src, att_dst


@pytest.mark.parametrize("case,message", [("cpu", "unsupported device"), ("f64", "contiguous f32"),
                                          ("shape", "expected"), ("strided", "contiguous f32")])
def test_check_refuses(case, message):
    xp, att_src, att_dst = _bad_operands(case)
    assert case == "shape" or xp.shape == (16, 2, 32)
    with pytest.raises(ValueError, match=message):
        gl._check("gat_logits_fwd", xp, att_src, att_dst)


# ---- the kernels' arithmetic, replayed -------------------------------------

def _pow2_cover(n, cap):
    p = 1
    while p < n and p < cap:
        p <<= 1
    return p


def _fmaf(a, b, c):
    """a·b + c rounded once to f32 (the product is exact in f64)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def replay_fwd(xp, att_src, att_dst, vec):
    """``csrc/gat_logits.cu``'s forward in numpy: per (n, h) segment, G
    lanes; lane g sums its channels (float4 slots 4g + 4G·k, each x, y, z, w
    in turn; or scalars g + G·k) in ascending order, one fmaf each; the group
    folds by a butterfly of xor shuffles; lane 0's value is written."""
    N, H, C = xp.shape
    G = _pow2_cover((C + 3) // 4 if vec else C, 32)
    x = xp.reshape(N * H, C)
    heads = np.arange(N * H) % H
    out = []
    for att in (att_src.reshape(H, C)[heads], att_dst.reshape(H, C)[heads]):
        lanes = np.zeros((N * H, G), np.float32)
        for g in range(G):
            if vec:
                chans = [c + q for c in range(4 * g, C, 4 * G) for q in range(4)]
            else:
                chans = list(range(g, C, G))
            for c in chans:
                lanes[:, g] = _fmaf(x[:, c], att[:, c], lanes[:, g])
        o = G // 2
        while o:
            lanes = lanes + lanes[:, np.arange(G) ^ o]
            o //= 2
        out.append(lanes[:, 0].reshape(N, H))
    return out


def replay_bwd(xp, att_src, att_dst, d_out, d_as, d_ad, vec):
    """``csrc/gat_logits.cu``'s backward in numpy: d xp as
    fmaf(d_ad, att_dst, fmaf(d_as, att_src, d_out)); the rows cut into
    chunks of TY · 16, row group ty of a chunk taking its rows ty, ty + TY, ...
    in ascending order (one fmaf each), the TY groups folded in a tree, one
    partial row a chunk; then 32 stripes of ascending chunks, folded in a
    tree."""
    N, H, C = xp.shape
    L = H * C
    TX = _pow2_cover(L // 4 if vec else L, THREADS)
    TY = THREADS // TX
    rows = TY * ROWS_PER_GROUP
    chunks = -(-N // rows)
    x, g = xp.reshape(N, L), d_out.reshape(N, L)
    head = np.arange(L) // C
    ws, wd = d_as[:, head], d_ad[:, head]                       # [N, L]
    s, d = att_src.reshape(L), att_dst.reshape(L)
    d_xp = _fmaf(wd, d[None], _fmaf(ws, s[None], g)).reshape(N, H, C)
    grads = []
    for w in (ws, wd):
        acc = np.zeros((chunks, TY, L), np.float32)
        base = np.arange(chunks)[:, None] * rows + np.arange(TY)[None, :]
        for i in range(ROWS_PER_GROUP):
            r = base + TY * i
            live = (r < N)[..., None]
            rc = np.minimum(r, N - 1)
            acc = np.where(live, _fmaf(w[rc], x[rc], acc), acc)
        st = TY // 2
        while st:
            acc[:, :st] = acc[:, :st] + acc[:, st:2 * st]
            st //= 2
        part = acc[:, 0]                                        # [chunks, L]
        stripes = np.zeros((STRIPES, L), np.float32)
        for k in range(chunks):
            stripes[k % STRIPES] = stripes[k % STRIPES] + part[k]
        st = STRIPES // 2
        while st:
            stripes[:st] = stripes[:st] + stripes[st:2 * st]
            st //= 2
        grads.append(stripes[0].reshape(1, H, C))
    return [d_xp] + grads


def _replay_cases():
    # the float4 loads where C % 4 == 0, the scalar loads at every width
    return [(H, C, vec) for H, C in WIDTHS for vec in (True, False) if not (vec and C % 4)]


@pytest.mark.parametrize("H,C,vec", _replay_cases())
def test_forward_replay(H, C, vec):
    xp, att_src, att_dst, _ = _operands(H, C)
    got = replay_fwd(*(t.numpy() for t in (xp, att_src, att_dst)), vec)
    for g, r in zip(got, gl.gat_logits_plain(xp, att_src, att_dst)):
        np.testing.assert_allclose(g, r.numpy(), rtol=1e-5, atol=1e-5 * float(r.abs().max()))


@pytest.mark.parametrize("H,C,vec", _replay_cases())
def test_backward_replay(H, C, vec):
    """Rows not a multiple of a chunk, and (at C 1) fewer rows than one
    chunk: every row is taken once."""
    N = 1000 if C > 1 else 5000
    xp, att_src, att_dst, cot = _operands(H, C, N=N)
    got = replay_bwd(*(t.numpy() for t in (xp, att_src, att_dst, *cot)), vec)
    ref = gl.gat_logits_bwd_plain(xp, att_src, att_dst, *cot)
    for name, g, r in zip(("d xp", "d att_src", "d att_dst"), got, ref):
        assert g.shape == tuple(r.shape), name
        assert _rel(torch.from_numpy(g), r) <= 1e-5, name


# ---- GATConv on the CPU ----------------------------------------------------

def _graph(mode, B=3):
    rng = np.random.default_rng(5)
    n = 40
    pairs = {(min(i, j), max(i, j)) for i, j in
             [(i, int(rng.integers(0, i))) for i in range(1, n)]
             + [tuple(rng.integers(0, n, 2)) for _ in range(30)] if i != j}
    und = np.array(sorted(pairs), np.int32)
    tpl = GraphTemplate(n, np.concatenate([und[:, 0], und[:, 1]]),
                        np.concatenate([und[:, 1], und[:, 0]]))
    return tpl.batch(B, mode=mode, band_block=8 if mode == "banded" else None, device="cpu")


def _conv(H, C, mode):
    torch.manual_seed(H * 1000 + C)
    conv = GATConv(16, C, heads=H, concat=H > 1, attn_impl="factored")
    graph = _graph(mode)
    n_rows = graph.n_graph * (graph.band_n_pad if mode == "banded" else graph.n_node // graph.n_graph)
    return conv, graph, torch.randn(n_rows, 16)


def _todays_forward(conv, x, graph):
    """GATConv's forward as it ran before the kernels: the halves as two
    multiplies and two sums, then the layer's own attention and tail."""
    H, C = conv.heads, conv.out_channels
    xp = conv.lin(x).view(-1, H, C)
    a_s = (xp * conv.att_src).sum(-1)
    a_d = (xp * conv.att_dst).sum(-1)
    B = graph.n_graph
    if graph.dense:
        out = conv._dense(xp.view(B, -1, H, C), a_s.view(B, -1, H), a_d.view(B, -1, H), graph)
    else:
        out = conv._banded(xp, a_s, a_d, graph)
    out = out.reshape(-1, H, C)
    out = out.reshape(-1, H * C) if conv.concat else out.mean(dim=1)
    return out + conv.bias


def _run(conv, x, graph, forward):
    x = x.clone().requires_grad_()
    out = forward(x, graph)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(11))
    grads = torch.autograd.grad((out * cot).sum(), [x, *conv.parameters()])
    return out.detach(), grads


@pytest.mark.parametrize("mode", ["banded", "dense"])
@pytest.mark.parametrize("H,C", WIDTHS)
def test_gatconv_on_the_cpu_is_unchanged(H, C, mode):
    conv, graph, x = _conv(H, C, mode)
    out, grads = _run(conv, x, graph, conv)
    ref_out, ref_grads = _run(conv, x, graph, lambda x, g: _todays_forward(conv, x, g))
    assert torch.equal(out, ref_out)
    for g, r in zip(grads, ref_grads):
        assert torch.equal(g, r)


@pytest.mark.parametrize("H,C", WIDTHS)
def test_gatconv_through_the_function(H, C, monkeypatch):
    """The card's route, ``GatLogits``, in the layer on the CPU: the
    attention gets the passed-through rows, the output is bit-equal and the
    gradients within 1e-6 of the layer's CPU route."""
    conv, graph, x = _conv(H, C, "banded")
    ref_out, ref_grads = _run(conv, x, graph, conv)
    calls = []
    monkeypatch.setattr(layers, "gat_logits",
                        lambda *a: calls.append(1) or gl.GatLogits.apply(*a))
    out, grads = _run(conv, x, graph, conv)
    assert calls == [1]
    assert torch.equal(out, ref_out)
    for g, r in zip(grads, ref_grads):
        assert _rel(g, r) <= 1e-6


@pytest.mark.parametrize("H,C", WIDTHS)
def test_the_entry_on_the_cpu_is_the_expression(H, C):
    """``gat_logits`` on CPU tensors: xp itself, and the halves with
    autograd's gradients of the layer's expression, bit for bit."""
    xp, att_src, att_dst, cot = _operands(H, C)
    leaves = [t.clone().requires_grad_() for t in (xp, att_src, att_dst)]
    xp_out, a_s, a_d = gl.gat_logits(*leaves)
    assert xp_out is leaves[0]
    loss = (xp_out * cot[0]).sum() + (a_s * cot[1]).sum() + (a_d * cot[2]).sum()
    for g, r in zip(torch.autograd.grad(loss, leaves),
                    _todays_grads(xp, att_src, att_dst, cot)):
        assert torch.equal(g, r)
