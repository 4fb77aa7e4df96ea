"""Start the ranks of a mesh on this host, one process each.

The JAX package runs a mesh as one program over the devices of one process
and needs no launcher; the port runs one rank per process
(``parallel.mesh``), so ``cli train | eval --mesh DP,GP`` and the tests start
them here::

    code = spawn(2, "gnn_pressure_estimation_tpu_torch.cli:rank_main",
                 payload=json.dumps(argv), device="cuda")

Each rank is a fresh ``python -m gnn_pressure_estimation_tpu_torch.parallel.launch``
process: it joins the process group (``tcp://127.0.0.1:<free port>``, the
backend by ``mesh.choose_backend``, the group timeout given), imports the
entry ``module:function`` and calls it with the payload string. The
package's root is put on the ranks' ``PYTHONPATH`` in front of the
caller's, so an entry point lives in the package, in a script beside it,
or in any module on that path; a rank imports only the entry's module,
never the caller's. The launcher returns 0 when every rank
exits 0; when a rank exits non-zero it stops the others and returns that
code, and past ``timeout_s`` it stops them all and returns 124. Every
process it starts is ended before it returns.
"""

from __future__ import annotations

import argparse
import importlib
import os
import socket
import subprocess
import sys
import time
import traceback
from typing import Optional

from gnn_pressure_estimation_tpu_torch.parallel.mesh import GROUP_TIMEOUT_S

PACKAGE_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(n_ranks: int, entry: str, payload: str = "", device: str = "cuda",
          timeout_s: float = 3600.0, group_timeout_s: float = GROUP_TIMEOUT_S,
          threads: Optional[int] = None) -> int:
    """Run ``entry`` (``"module:function"``) on ``n_ranks`` local ranks; see
    the module docstring. ``threads`` sets ``torch.set_num_threads`` in each
    rank (the CPU tests take 1)."""
    init = f"tcp://127.0.0.1:{free_port()}"
    child_env = dict(os.environ)
    child_env["PYTHONPATH"] = os.pathsep.join(
        [PACKAGE_ROOT] + [p for p in child_env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs = []
    try:
        for r in range(n_ranks):
            cmd = [sys.executable, "-m", "gnn_pressure_estimation_tpu_torch.parallel.launch",
                   "--rank", str(r), "--world", str(n_ranks), "--init", init,
                   "--device", device, "--entry", entry, "--payload", payload,
                   "--group_timeout", str(group_timeout_s)]
            if threads is not None:
                cmd += ["--threads", str(threads)]
            procs.append(subprocess.Popen(cmd, env=child_env))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                print(f"launch: a rank exited with {failed[0]}; stopping the others",
                      file=sys.stderr, flush=True)
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if time.monotonic() > deadline:
                print(f"launch: ranks still running after {timeout_s:.0f} s; stopping them",
                      file=sys.stderr, flush=True)
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.terminate()
        for p in procs:
            try:
                p.wait(timeout=10)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()


def _child(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--entry", required=True)
    ap.add_argument("--payload", default="")
    ap.add_argument("--group_timeout", type=float, default=GROUP_TIMEOUT_S)
    ap.add_argument("--threads", type=int, default=None)
    a = ap.parse_args(argv)
    import datetime

    import torch
    import torch.distributed as dist

    from gnn_pressure_estimation_tpu_torch.parallel.mesh import choose_backend, rank_device

    if a.threads is not None:
        torch.set_num_threads(a.threads)
    backend, why = choose_backend(torch.device(a.device).type, a.world)
    rank_device(a.device, a.rank)
    dist.init_process_group(backend, init_method=a.init, world_size=a.world, rank=a.rank,
                            timeout=datetime.timedelta(seconds=a.group_timeout))
    if a.rank == 0:
        print(f"launch: {a.world} rank(s), backend {backend} ({why})", flush=True)
    try:
        mod, fn = a.entry.split(":")
        code = getattr(importlib.import_module(mod), fn)(a.payload)
    except SystemExit as e:
        code = e.code if isinstance(e.code, int) else (0 if e.code is None else 1)
        if code:
            print(f"rank {a.rank}: {e.code}", file=sys.stderr, flush=True)
    except Exception:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)          # no group teardown: the peers may be stuck in a collective
    dist.destroy_process_group()
    return int(code or 0)


if __name__ == "__main__":
    sys.exit(_child())
