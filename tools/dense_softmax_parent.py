"""The dense softmax forward on one card: the kept kernel (v2's row walk on
the band of one block, ``csrc/fused_attention.cu``) beside the parent tree's
(one warp per row and head, three passes over the row's list).

    python3 tools/dense_softmax_parent.py --parent DIR [--out FILE]

Needs a CUDA card and ``nvcc``. ``DIR`` holds the parent's
``gnn_pressure_estimation_tpu_torch/csrc`` (``git archive <commit>
gnn_pressure_estimation_tpu_torch/csrc`` is enough); its
``fused_attention.cu`` is built into the package's git-ignored
``_build/variants/`` and called through its C entry. On synthctown's mask
(388 nodes, its ``MaskIndex``) at B 32 and the four shapes GATRes-small and
-large run (H·C 64, 32, 256, 128), on seeded random inputs with a third of
the nodes' logit halves zeroed, it prints the largest deviation of the kept
kernel from the parent's and of both from the plain version (atol/rtol
1e-4, or it fails), then the device time of each (``torch.profiler``) and
its CUDA-event time, in turns parent, change, change, parent, beside the
byte bound. ``--out``: the numbers as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
SHAPES = ((2, 32), (1, 32), (2, 128), (1, 128))     # conv1, conv2 of small; of large


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="a tree holding the parent's csrc")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("dense_softmax_parent: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.ops import _build
    from gnn_pressure_estimation_tpu_torch.ops import graph_attention as ga

    card = cs.smi_line()
    out_dir = os.path.join(_build.BUILD_DIR, "variants", "parent")
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, "fused_attention.so")
    src = os.path.join(args.parent, "gnn_pressure_estimation_tpu_torch", "csrc", "fused_attention.cu")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(so).fused_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    dev = torch.device("cuda")
    wn = parse_inp(os.path.join(ROOT, "inputs", "synthctown.inp"))
    tpl, _ = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                            name="synthctown")
    n = tpl.n_node
    mask = torch.as_tensor(tpl.dense_operators()["adj_sl_mask"], device=dev)
    ix = tpl.dense_index().to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    B = 32
    result = {"card": card, "rows": []}
    print(f"{card}; synthctown n {n}, mask nonzeros {ix.nnz}, B {B}")
    for H, C in SHAPES:
        a_d, a_s = (torch.randn((B, n, H), generator=gen, device=dev) for _ in range(2))
        a_d[:, ::3] = 0.0
        a_s[:, ::3] = 0.0
        v = torch.randn((B, n, H, C), generator=gen, device=dev)

        def parent():
            out = torch.empty_like(v)
            with torch.cuda.device(dev):
                rc = fn(a_d.data_ptr(), a_s.data_ptr(), v.data_ptr(), ix.row_ptr.data_ptr(),
                        ix.col.data_ptr(), out.data_ptr(), B, n, H, C, 0.2,
                        torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise SystemExit(f"FAIL the parent's kernel: CUDA error {rc}")
            return out

        def change():
            return ga.fused_attention_fwd(a_d, a_s, v, mask, 0.2, ix)

        ref = ga.fused_attention_plain(a_d, a_s, v, mask, 0.2)
        old, new = parent(), change()
        for who, got in (("parent", old), ("change", new)):
            cs.check_close(f"{who} H{H} C{C} vs plain", got, ref, cs.TOL, cs.TOL, verbose=False)
        dev_old = float((new - old).abs().max())
        t = {"parent": [], "change": []}
        d = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            run = parent if who == "parent" else change
            t[who].append(cs.cuda_ms(run, 5, 50))
            d[who].append(cs.device_ms(run))
        nbytes = 4 * (2 * B * n * H + 2 * B * n * H * C) + 4 * (n + 1 + ix.nnz)
        bound = nbytes / cs.PEAK_BYTES_S * 1e3
        row = dict(H=H, C=C, max_dev_from_parent=dev_old, events_ms=t, device_ms=d, bound_ms=bound)
        result["rows"].append(row)
        print(f"  H {H} C {C}: kept kernel within {dev_old:.3e} of the parent's; device ms parent "
              + " / ".join(cs.fmt_ms(x) for x in d["parent"]) + ", change "
              + " / ".join(cs.fmt_ms(x) for x in d["change"]) + "; events ms parent "
              + " / ".join(f"{x:.4f}" for x in t["parent"]) + ", change "
              + " / ".join(f"{x:.4f}" for x in t["change"]) + f"; byte bound {bound:.5f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
