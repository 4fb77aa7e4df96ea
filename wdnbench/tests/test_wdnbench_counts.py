"""The count arithmetic against hand counts, its independence of the band
layout, and the trace reading (busy union, groups, idle gaps)."""

import json

import numpy as np
import pytest

from wdnbench import counts, trace


def test_counts_match_hand_counts():
    # B 2 graphs of n 3 nodes and E 4 directed edges; 1 block, C 2, heads 2 and 1
    s = counts.Shapes(B=2, n=3, E=4, blocks=1, channels=2, heads1=2, heads2=1)
    assert (s.N, s.edges, s.edges_sl) == (6, 8, 14)
    # conv1's aggregation: 2·C·H a self-looped edge; rows 6·2·2 read and written,
    # the halves 2·6·2, four bytes each; 14 edges of 8 bytes
    a1 = counts.attention_fwd(s, 2)
    assert a1.flops == 2 * 2 * 2 * 14
    assert a1.bytes == 4 * (2 * 6 * 4 + 2 * 6 * 2) + 8 * 14
    b1 = counts.attention_bwd(s, 2)
    assert b1.flops == 4 * 2 * 2 * 14
    assert b1.bytes == 4 * (3 * 6 * 4 + 4 * 6 * 2) + 8 * 14
    sp = counts.spmm(s)
    assert (sp.flops, sp.bytes) == (2 * 2 * 8, 4 * 2 * 6 * 2 + 8 * 8)
    # GEMMs 2·N·(C·2C + 2C·C) = 2·6·16, attention 2·C·3 heads·14, mean 2·C·8, lin0+lin1 2·6·2·2
    fwd = 2 * 6 * 16 + 2 * 2 * 3 * 14 + 2 * 2 * 8 + 2 * 6 * 2 * 2
    assert counts.model_flops(s, train=False) == fwd
    assert counts.model_flops(s, train=True) == 3 * fwd
    train = counts.attention_work(s, train=True)
    assert train.flops == a1.flops + counts.attention_fwd(s, 1).flops + b1.flops \
        + counts.attention_bwd(s, 1).flops


def test_gatres_large_batch_counts():
    # about 630 GFLOP a bigtown batch of 32 and 1.87 TFLOP a meganet step of 8
    big = counts.Shapes(B=32, n=5800, E=20972, blocks=25, channels=128, heads1=2, heads2=1)
    mega = counts.Shapes(B=8, n=23000, E=82914, blocks=25, channels=128, heads1=2, heads2=1)
    assert 0.60e12 < counts.model_flops(big, train=False) < 0.66e12
    assert 1.80e12 < counts.model_flops(mega, train=True) < 1.95e12
    conv1 = counts.attention_fwd(big, 2)
    assert conv1.bound_by() == "bytes" and 0.37e9 < conv1.bytes < 0.40e9


@pytest.mark.parametrize("blocks", [(256, 128), (128, 64)])
def test_counts_do_not_see_the_band_layout(blocks):
    """Two band layouts of one network (other block rows, other halo) hold
    the same edges, and the counts, taken from the network alone, agree with
    what either layout's attention mask holds."""
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp, write_inp
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_wdn

    wn = parse_inp(write_inp(make_wdn(1500, seed=4)))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None)
    shapes = []
    for blk in blocks:
        bl = tpl.band_layout(blk)
        # the attention's edges: the graph's plus a self-loop a real node
        assert int(np.count_nonzero(bl.adj_mask)) == tpl.n_edge + tpl.n_node
        assert int(bl.adj_cnt.sum()) == tpl.n_edge
        shapes.append(counts.Shapes(B=4, n=tpl.n_node, E=tpl.n_edge, blocks=25, channels=128,
                                    heads1=2, heads2=1))
    a, b = shapes
    for fn in (lambda s: counts.attention_work(s, True), lambda s: counts.spmm_work(s, True)):
        assert fn(a) == fn(b)
    assert tpl.band_layout(blocks[0]).W != tpl.band_layout(blocks[1]).W


def test_idle_share_is_the_union_not_the_sum():
    iv = [(0.0, 2.0), (1.0, 3.0), (5.0, 6.0)]
    merged = trace.merge(iv)
    assert merged == [[0.0, 3.0], [5.0, 6.0]]
    busy = sum(e - s for s, e in merged)
    assert busy == 4.0
    assert counts.idle_pct(busy, 8.0) == pytest.approx(50.0)
    assert counts.roofline_pct(1.0, 0.0) is None
    assert counts.mfu_pct(67e12, 1.0) == pytest.approx(100.0)


def test_trace_summary_groups_gaps_and_names(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "band_spmm.cu").write_text(
        "__global__ void __launch_bounds__(kWarps * 32)\nband_spmm_fwd_kernel(const float* x) {}")
    (csrc / "band_rowwalk.cuh").write_text(
        "template <int NV>\n__global__ void __launch_bounds__(128, 2)\nband_rowwalk_kernel(int a) {}\n"
        "__global__ void __launch_bounds__(kThreads, min_blocks(NV, kBf16))\n"
        "columns_kernel(const typename XRow<kBf16>::T* x) {}")
    own = trace.kernel_groups(csrc)
    assert own == {"band_spmm_fwd_kernel": "spmm", "band_rowwalk_kernel": "attn",
                   "columns_kernel": "attn"}
    ev = [
        {"ph": "X", "cat": "kernel", "ts": 0, "dur": 10,
         "name": "void (anonymous namespace)::band_rowwalk_kernel<2, false>(float const*)"},
        {"ph": "X", "cat": "kernel", "ts": 5, "dur": 10, "name": "band_spmm_fwd_kernel<true>"},
        # a GEMM is told by the operator that launched it, not by its name
        {"ph": "X", "cat": "kernel", "ts": 30, "dur": 5, "name": "Kernel2",
         "args": {"correlation": 7}},
        {"ph": "X", "cat": "kernel", "ts": 40, "dur": 4,
         "name": "void at::native::vectorized_elementwise_kernel<4>(int)",
         "args": {"correlation": 8}},
        {"ph": "X", "cat": "kernel", "ts": 46, "dur": 1,
         "name": "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x32",
         "args": {"correlation": 9}},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 50, "dur": 2, "name": "Memcpy HtoD"},
        {"ph": "X", "cat": "cpu_op", "ts": 14, "dur": 20, "name": "aten::copy_",
         "pid": 1, "tid": 1},
        {"ph": "X", "cat": "cuda_runtime", "ts": 16, "dur": 2, "name": "cudaMemcpyAsync",
         "pid": 1, "tid": 1},
        # aten::linear > aten::addmm > the launch: the innermost operator counts
        {"ph": "X", "cat": "cpu_op", "ts": 1, "dur": 8, "name": "aten::linear",
         "pid": 1, "tid": 2},
        {"ph": "X", "cat": "cpu_op", "ts": 2, "dur": 6, "name": "aten::addmm",
         "pid": 1, "tid": 2},
        {"ph": "X", "cat": "cuda_driver", "ts": 3, "dur": 1, "name": "cuLaunchKernelEx",
         "pid": 1, "tid": 2, "args": {"correlation": 7}},
        # an elementwise kernel launched inside a product's copy is glue
        {"ph": "X", "cat": "cpu_op", "ts": 9, "dur": 4, "name": "aten::matmul",
         "pid": 1, "tid": 3},
        {"ph": "X", "cat": "cpu_op", "ts": 10, "dur": 2, "name": "aten::copy_",
         "pid": 1, "tid": 3},
        {"ph": "X", "cat": "cuda_runtime", "ts": 11, "dur": 0.5, "name": "cudaLaunchKernel",
         "pid": 1, "tid": 3, "args": {"correlation": 8}},
    ]
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": ev}))
    s = trace.summarize(path, own)
    # the kernel named like a GEMM but linked to no operator is glue
    assert s["groups"] == pytest.approx({"attn": 10e-6, "spmm": 10e-6, "gemm": 5e-6,
                                         "glue": 5e-6, "copy": 2e-6})
    assert s["kernels_unlinked"] == 3
    assert s["busy_s"] == pytest.approx(27e-6)
    assert s["span_s"] == pytest.approx(52e-6)
    gaps = dict(s["idle_gaps"])
    # 15-30: the host in aten::copy_ at 22.5; 35-40, 44-46 and 47-50: no profiled op
    assert gaps["aten::copy_"] == pytest.approx(15e-6)
    assert gaps["host: Python, no profiled op"] == pytest.approx(10e-6)
    assert s["device_ops"][0][0] in ("band_rowwalk_kernel", "band_spmm_fwd_kernel")


def test_every_kernel_of_the_program_is_named():
    """Each ``__global__`` of the program's sources is found, none twice
    under another group, and the SpMM pair alone is the SpMM's."""
    import re

    from wdnbench import traffic

    csrc = traffic.program_dir() / "csrc"
    own = trace.kernel_groups(csrc)
    declared = sum(len(re.findall(r"__global__", p.read_text())) for p in csrc.glob("*.cu*"))
    found = sum(len(trace.global_names(p.read_text())) for p in csrc.glob("*.cu*"))
    assert found == declared
    assert all(re.fullmatch(r"[a-z][a-z0-9_]*_kernel", n) for n in own), own
    assert {n for n, g in own.items() if g == "spmm"} == {"band_spmm_fwd_kernel",
                                                          "band_spmm_bwd_kernel"}
    assert {"columns_kernel", "cells_kernel", "weights_kernel", "rows_kernel",
            "band_rowwalk_kernel", "window_mean_kernel", "empties_kernel"} <= set(own)
