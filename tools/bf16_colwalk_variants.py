"""The bf16-operand column walk (``csrc/band_colwalk.cuh``, ``kBf16``) on one card:
its build variants, and the parent tree's round-on-load backwards beside it.

    python3 tools/bf16_colwalk_variants.py [--parent DIR] [--out FILE]

Needs a CUDA card and ``nvcc``. Builds the three backwards that run the walk,
``csrc/band_attention_bwd.cu`` (v2), ``csrc/band_attention_acc_bwd.cu`` (v3,
the same passes) and ``csrc/band_attention_flash_bwd.cu`` (v4), once as they
stand (the kept build), and v2's and v4's once for each variant, from a copy
of ``csrc`` with the walk's constants rewritten (``kBf16Depth``: dO rows
staged at once at NV 1 and NV 2; ``kBf16MinBlocks``: thread blocks of 8
warps an SM must hold, which caps the registers) or a patch of
``tools/bf16_colwalk_patches/`` applied to its ``band_colwalk.cuh``
(``wide``: x_ext[e] widened once as it is loaded, not held as packed bf16
quads; ``single``: a staged dO slot rounded one channel a conversion, not
two; ``copy``: dO written once as bf16 before the pass, into a scratch the
library keeps, which then stages 8-byte dO slots at twice the depth and
rounds nothing in its loop), all ``nvcc`` at once, and prints each bf16
columns instance's registers and spills.

On seeded inputs at the main path's shapes (bigtown B 32 and B 8 through v2
and v3, meganet B 8 and B 2 through v4, H·C 256 and 128; random logit
halves, a third of them zeroed; the v4 statistics and delta from the bf16
forward) it holds the kept build against the plain version (1e-4), v3's
outputs equal to v2's and every variant's equal to the kept build's (bit for
bit: d a_dst, d a_src_win, d x_ext), then times each variant beside the f32
instance of the kept build on the same inputs (CUDA events, 20 launches
after 3, in turns), with the byte bound at 2-byte x rows.

``--parent DIR``: a checkout of the tree whose bf16 backwards read f32 x_ext
and round each x as they load it. Its three sources are built from DIR's
``csrc`` and called through their C entries on the f32 rows; all three
outputs must equal the kept build's on the stored bf16 rows bit for bit;
then parent and kept build are timed in turns (parent, change, change,
parent).

``--out``: the numbers as JSON. Builds and the variants' sources go to the
package's git-ignored ``_build/colwalk_variants/``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.normpath(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
SOURCES = ("band_attention_bwd", "band_attention_acc_bwd", "band_attention_flash_bwd")
KEPT = "kept"
PATCHES = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bf16_colwalk_patches")
# tag → the constants of csrc/band_colwalk.cuh it rewrites, or the patch it
# applies (the kept build: depth {8, 6}, blocks {4, 3}, x packed, two channels
# a conversion, no dO copy)
VARIANTS = {
    "wide": "wide.patch",                          # x_ext[e] widened once, as it is loaded
    "deep": {"kBf16Depth": "{12, 8}"},             # more dO rows in flight, fewer blocks fit
    "d4m4": {"kBf16Depth": "{8, 4}", "kBf16MinBlocks": "{4, 4}"},   # NV 2 at 64 registers
    "m4": {"kBf16MinBlocks": "{4, 4}"},            # NV 2 at 64 registers, 6 rows staged
    "m5": {"kBf16Depth": "{6, 6}", "kBf16MinBlocks": "{5, 3}"},     # NV 1 at 48 registers
    "single": "single.patch",                      # dO rounded one channel a conversion
    "copy": "copy.patch",                          # dO as bf16, 8-byte slots, twice the depth
}


def apply_patch(text: str, patch: str) -> str:
    """``text`` with the unified diff ``patch`` applied: each hunk's old
    lines (context and removals) must occur in it exactly once."""
    hunks = re.split(r"^@@[^\n]*\n", patch, flags=re.M)[1:]
    for hunk in hunks:
        old, new = [], []
        for line in hunk.splitlines(keepends=True):
            tag, body = line[:1], line[1:]
            if tag in (" ", "-"):
                old.append(body)
            if tag in (" ", "+"):
                new.append(body)
        old, new = "".join(old), "".join(new)
        if text.count(old) != 1:
            raise SystemExit(f"FAIL patch: a hunk's lines occur {text.count(old)} times, not once")
        text = text.replace(old, new)
    return text


def variant_sources(csrc: str, out_dir: str, tag: str, change) -> str:
    """A copy of ``csrc`` under ``out_dir`` with the bf16 column walk's
    constants rewritten (``change`` a dict) or a patch of ``PATCHES`` applied
    (``change`` its file name); returns its directory."""
    dst = os.path.join(out_dir, tag, "csrc")
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(csrc, dst)
    path = os.path.join(dst, "band_colwalk.cuh")
    with open(path) as f:
        text = f.read()
    if isinstance(change, str):
        with open(os.path.join(PATCHES, change)) as f:
            text = apply_patch(text, f.read())
        change = {}
    for name, val in change.items():
        pat = rf"(constexpr int {name}\[2\] = )[^;]+;"
        text, n = re.subn(pat, rf"\g<1>{val};", text)
        if n != 1:
            raise SystemExit(f"FAIL {path}: {name} found {n} times, not once")
    with open(path, "w") as f:
        f.write(text)
    return dst


def build(csrc: str, out_dir: str, tag: str, sources) -> dict:
    """Start one ``nvcc`` per source of ``csrc``; returns {source: (library
    path, process)}."""
    from gnn_pressure_estimation_tpu_torch.ops import _build

    procs = {}
    for src in sources:
        so = os.path.join(out_dir, f"{src}-{tag}.so")
        procs[src] = (so, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", so, os.path.join(csrc, f"{src}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    return procs


def finish(procs: dict) -> dict:
    out = {}
    for src, (so, p) in procs.items():
        log = p.communicate()[0]
        if p.returncode != 0:
            raise SystemExit(f"FAIL build of {so}:\n{log}")
        fn = getattr(ctypes.CDLL(so), src)
        n_ptr = 20 if src.endswith("flash_bwd") else 17
        fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 10 + [ctypes.c_float,
                                                                          ctypes.c_void_p]
        fn.restype = ctypes.c_int
        out[src] = (fn, log)
    return out


def launch(fn, flash, a_dst, a_src, x, ix, d_out, stats, bf16):
    """One backward through a C entry: (d a_dst, d a_src_win, d x_ext).
    ``stats``: v4's (m, Z, delta), else ()."""
    from gnn_pressure_estimation_tpu_torch.ops import banded as bops

    nB, BLK, W = ix.nB, ix.BLK, ix.W
    B, n_ext, H, C = x.shape
    dev = x.device
    nnz, n_empty = ix.nnz, int(ix.empty_row.shape[0])

    def new(*shape):
        return torch.empty(shape, dtype=torch.float32, device=dev)
    d_a_dst, d_a_src, d_x = new(B, nB * BLK, H), new(nB, B, W, H), new(B, n_ext, H, C)
    sp, sdz = new(B, max(nnz, 1), H), new(B, max(nnz, 1), H)
    ss = new(B, nB, H, C) if n_empty else new(1)
    vec = bops.vector_loads(x, C) and bops.vector_loads(d_out, C)
    lead = [a_dst.data_ptr(), a_src.data_ptr(), x.data_ptr()]
    lead += [t.data_ptr() for t in stats] + [d_out.data_ptr()] if flash else [d_out.data_ptr()]
    rc = fn(*lead, ix.row_ptr.data_ptr(), ix.col.data_ptr(), ix.t_ptr.data_ptr(),
            ix.t_entry.data_ptr(), ix.t_row.data_ptr(), ix.empty_ptr.data_ptr(),
            ix.empty_row.data_ptr(), sp.data_ptr(), sdz.data_ptr(), ss.data_ptr(),
            d_a_dst.data_ptr(), d_a_src.data_ptr(), d_x.data_ptr(),
            B, nB, BLK, W, H, C, nnz, n_empty, int(vec), int(bf16), 0.2,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise SystemExit(f"FAIL launch: CUDA error {rc}")
    return d_a_dst, d_a_src, d_x


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="a checkout of the tree whose bf16 backwards round x on load")
    ap.add_argument("--out", help="write the numbers as JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bf16_colwalk_variants: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from chip_smoke import PEAK_BYTES_S, band_bwd_bytes, cuda_ms, ptxas_table, smi_line
    from gnn_pressure_estimation_tpu_torch.data.dataset import build_template, get_keep_list
    from gnn_pressure_estimation_tpu_torch.data.inp import parse_inp
    from gnn_pressure_estimation_tpu_torch.ops import _build
    from gnn_pressure_estimation_tpu_torch.ops import band_attention as ba
    from gnn_pressure_estimation_tpu_torch.simgen.netgen import make_mega

    dev = torch.device("cuda")
    card = smi_line()
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    out_dir = os.path.join(_build.BUILD_DIR, "colwalk_variants")
    os.makedirs(out_dir, exist_ok=True)
    csrc = str(_build.CSRC_DIR)
    pair = ("band_attention_bwd", "band_attention_flash_bwd")
    t0 = time.perf_counter()
    procs = {KEPT: build(csrc, out_dir, KEPT, SOURCES)}
    for tag, change in VARIANTS.items():
        procs[tag] = build(variant_sources(csrc, out_dir, tag, change), out_dir, tag, pair)
    if args.parent:
        procs["parent"] = build(os.path.join(args.parent, "gnn_pressure_estimation_tpu_torch",
                                             "csrc"), out_dir, "parent", SOURCES)
    libs = {tag: finish(p) for tag, p in procs.items()}
    print(f"built {sum(len(p) for p in procs.values())} libraries in "
          f"{time.perf_counter() - t0:.1f} s")
    result = {"card": card, "registers": {}, "rows": [], "parent": []}
    for tag, srcs in libs.items():
        for src, (_, log) in srcs.items():
            for fn, regs, stack, st, ld in ptxas_table(log):
                if fn.startswith("columns_kernel") and (tag == KEPT or fn.endswith("true>")):
                    result["registers"].setdefault(tag, {})[f"{src} {fn}"] = [regs, stack, st, ld]
                    print(f"  {tag} {src}: {fn}: {regs} registers, {stack} bytes stack, "
                          f"spill {st} / {ld}")

    gen = torch.Generator(device=dev).manual_seed(14)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    nets = {}
    for name, wn in (("bigtown", parse_inp(os.path.join(ROOT, "inputs", "bigtown.inp"))),
                     ("meganet", make_mega())):
        nets[name] = build_template(wn, get_keep_list(wn, "keep_junction", None, "pressure"), None,
                                    name=name)[0]
    for net, flash, batches in (("bigtown", False, (32, 8)), ("meganet", True, (8, 2))):
        tpl = nets[net]
        bl = tpl.band_layout()
        mask = torch.as_tensor(bl.adj_mask.view(np.int8), device=dev)
        ix = tpl.band_index("adj_mask").to(dev)
        nB, BLK, W = bl.adj_mask.shape
        n_pad, n_ext = nB * BLK, nB * BLK + W - BLK
        routes = ("band_attention_flash_bwd",) if flash else ("band_attention_bwd",
                                                              "band_attention_acc_bwd")
        for B in batches:
            for H, C in ((2, 128), (1, 128)):
                a_dst, a_src = randn(B, n_pad, H), randn(nB, B, W, H)
                a_dst[:, ::3] = 0.0
                a_src[:, :, ::3] = 0.0
                x, d_out = randn(B, n_ext, H, C), randn(B, n_pad, H, C)
                xb = x.to(torch.bfloat16)
                stats = ()
                if flash:
                    out, m, Z = ba.band_attention_flash_fwd(a_dst, a_src, xb, mask, 0.2, ix, True)
                    stats = (m, Z, (d_out * out).sum(dim=-1))
                    del out
                label = f"{net} B {B} H·C {H * C}"
                src = routes[0]
                kept = launch(libs[KEPT][src][0], flash, a_dst, a_src, xb, ix, d_out, stats, True)
                plain = (ba.band_attention_flash_bwd_plain(a_dst, a_src, xb, mask, *stats, d_out,
                                                           0.2, True) if flash else
                         ba.band_attention_bwd_plain(a_dst, a_src, xb, mask, d_out, 0.2, True))
                err = max(float((k - p).abs().max()) for k, p in zip(kept, plain))
                if not all(torch.allclose(k, p, atol=1e-4, rtol=1e-4) for k, p in zip(kept, plain)):
                    raise SystemExit(f"FAIL {src} bf16 {label}: {err:.3e} from the plain version")
                del plain
                if not flash:
                    acc = launch(libs[KEPT]["band_attention_acc_bwd"][0], flash, a_dst, a_src, xb,
                                 ix, d_out, stats, True)
                    if not all(torch.equal(a, k) for a, k in zip(acc, kept)):
                        raise SystemExit(f"FAIL band_attention_acc_bwd bf16 {label}: not v2's")
                    del acc
                for tag in VARIANTS:
                    got = launch(libs[tag][src][0], flash, a_dst, a_src, xb, ix, d_out, stats, True)
                    if not all(torch.equal(g, k) for g, k in zip(got, kept)):
                        raise SystemExit(f"FAIL {src} {tag} {label}: not the kept build's output")
                nbytes = band_bwd_bytes(B, nB, BLK, W, H, C, ix.nnz, 2, flash)
                bound = nbytes / PEAK_BYTES_S * 1e3
                for route in routes:
                    def run(tag, xx=xb, bf=True, route=route):
                        lib = libs[tag].get(route) or libs[tag][src]
                        return lambda: launch(lib[0], flash, a_dst, a_src, xx, ix, d_out, stats, bf)
                    tags = (KEPT, *VARIANTS) if route == src else (KEPT,)
                    t = {"f32": []}
                    for tag in ("f32", *tags, *tags[::-1], "f32"):
                        fn = run(KEPT, x, False) if tag == "f32" else run(tag)
                        t.setdefault(tag, []).append(cuda_ms(fn, 3, 20))
                    row = dict(src=route, net=net, B=B, hc=H * C, bound_ms=bound, bytes=nbytes,
                               plain_err=err, ms=t)
                    result["rows"].append(row)
                    print(f"  {route} bf16 {label}: within {err:.3e} of plain; v3 v2's and every "
                          f"variant the kept build's bit for bit; bound {bound:.4f} ms at 2-byte x "
                          f"rows ({nbytes / 1e6:.1f} MB); ms: "
                          + ", ".join(f"{k} " + " / ".join(f"{v:.4f}" for v in vs)
                                      for k, vs in t.items()))
                    if args.parent:
                        old = launch(libs["parent"][route][0], flash, a_dst, a_src, x, ix, d_out,
                                     stats, True)
                        same = [torch.equal(o, k) for o, k in zip(old, kept)]
                        if not all(same):
                            raise SystemExit(f"FAIL {route} bf16 {label}: not the parent's outputs "
                                             f"(d a_dst, d a_src_win, d x_ext: {same})")
                        del old
                        par = run("parent", x)
                        tp = {"parent": [], "change": []}
                        for who in ("parent", "change", "change", "parent"):
                            tp[who].append(cuda_ms(par if who == "parent" else run(KEPT), 3, 20))
                        result["parent"].append(dict(src=route, net=net, B=B, hc=H * C, ms=tp,
                                                     outputs_equal=True))
                        print(f"  {route} bf16 {label} against the parent (f32 x_ext, rounded on "
                              f"load): d a_dst, d a_src_win, d x_ext equal bit for bit; parent "
                              + " / ".join(f"{v:.4f}" for v in tp["parent"]) + " ms, change "
                              + " / ".join(f"{v:.4f}" for v in tp["change"]) + " ms (in turns)")
                del a_dst, a_src, x, xb, d_out, kept, stats
                torch.cuda.empty_cache()
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps({"ok": True, "card": card}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
