"""The data × graph process mesh over ``torch.distributed``.

The counterpart of ``gnn_pressure_estimation_tpu/parallel/mesh.py`` and of
``init_distributed`` (``parallel/trainer.py``). The JAX package holds one
``("data", "graph")`` device mesh in one process, ``shard_map`` places its
collectives, and device ``(d, g)`` is ``devices[d·gp + g]``. The port runs
one rank per process instead (``parallel.launch`` starts them, or an outside
launch that :func:`init_distributed` joins):

- rank ``r`` sits at ``(d, g) = divmod(r, gp)``, the JAX device order;
- the **graph** group holds the ranks of one ``d`` (the node blocks of one
  batch shard: the halo ring, the edge partition's all-gather), the
  **data** group the ranks of one ``g``; the world group holds both axes
  (the gradient, loss and metric sums);
- the backend is NCCL when every rank of the host has its own card and gloo
  otherwise (:func:`choose_backend`, a stated rule, printed; never chosen by
  catching an error); NCCL moves CUDA tensors, gloo moves host copies of
  them (it has no point-to-point or reduce-scatter on CUDA tensors);
- compute stays on the rank's device: ``cuda:(r mod device_count)``, or
  the CPU when the caller asks for it.

Every process group gets a timeout (:data:`GROUP_TIMEOUT_S`, or the
launcher's ``group_timeout_s``), so a lost rank ends the run instead of
hanging it.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional

import torch
import torch.distributed as dist

from gnn_pressure_estimation_tpu_torch.device import resolve_device

GROUP_TIMEOUT_S = 300.0


def choose_backend(device_type: str, ranks_on_host: int) -> tuple[str, str]:
    """``(backend, reason)``: NCCL when the ranks run on cards and the host
    has a card for each of its ranks, gloo otherwise (CPU ranks, or ranks
    that share a card: NCCL puts one rank on a device)."""
    if device_type == "cuda":
        cards = torch.cuda.device_count()
        if cards >= ranks_on_host:
            return "nccl", f"{ranks_on_host} rank(s) on {cards} card(s): one card a rank"
        return "gloo", (f"{ranks_on_host} ranks share {cards} card(s): NCCL takes one rank a "
                        "card, so gloo, moving host copies")
    return "gloo", "CPU ranks"


def rank_device(device, rank: int) -> torch.device:
    """The rank's compute device: ``cuda:(rank mod device_count)`` for a CUDA
    request (raising without a card), else the device asked for."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def init_distributed(coordinator: Optional[str] = None, num_processes: Optional[int] = None,
                     process_id: Optional[int] = None, device="cuda") -> str:
    """Join a launch started outside: ``coordinator`` ``host:port`` with
    ``num_processes`` and this process's ``process_id``, or, without a
    coordinator, the environment (``MASTER_ADDR``, ``MASTER_PORT``,
    ``WORLD_SIZE``, ``RANK``). The backend follows :func:`choose_backend`
    with the host's ranks ``LOCAL_WORLD_SIZE`` from the environment, else
    every process of the launch; the group timeout is
    :data:`GROUP_TIMEOUT_S`. Returns the backend."""
    if coordinator:
        if num_processes is None or process_id is None:
            raise ValueError("a coordinator needs num_processes and process_id")
        init, world, rank = f"tcp://{coordinator}", int(num_processes), int(process_id)
    else:
        init = "env://"
        world, rank = int(os.environ["WORLD_SIZE"]), int(os.environ["RANK"])
    ranks_on_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    dev_type = torch.device(device).type
    backend, why = choose_backend(dev_type, ranks_on_host)
    rank_device(device, rank)          # raises before joining when no card is present
    dist.init_process_group(backend, init_method=init, world_size=world, rank=rank,
                            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    print(f"rank {rank}/{world}: backend {backend} ({why})", flush=True)
    return backend


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """One rank's view of the ``dp × gp`` mesh: its coordinates, groups,
    backend and device, and the collectives the parallel strategies call."""

    dp: int
    gp: int
    rank: int
    backend: str
    device: torch.device
    graph_group: object = dataclasses.field(repr=False)
    data_group: object = dataclasses.field(repr=False)
    # the halo exchanges this rank made (forward and backward), the bytes it
    # sent, and, while ``timing`` is set, the seconds spent in them (the
    # device synchronised around each); ``parallel.halo`` counts them
    exchanges: dict = dataclasses.field(
        default_factory=lambda: {"calls": 0, "bytes": 0, "seconds": 0.0, "timing": False},
        repr=False)

    @property
    def d(self) -> int:
        return self.rank // self.gp

    @property
    def g(self) -> int:
        return self.rank % self.gp

    @property
    def world(self) -> int:
        return self.dp * self.gp

    def graph_rank(self, g: int) -> int:
        """The global rank of graph position ``g`` in this rank's data row."""
        return self.d * self.gp + g

    # -- transport --------------------------------------------------------
    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """What the backend moves: a host copy under gloo, the tensor under NCCL."""
        t = t.contiguous()
        return t.cpu() if self.backend == "gloo" else t

    def _group(self, axis: str):
        return {"graph": self.graph_group, "data": self.data_group, "world": None}[axis]

    def _size(self, axis: str) -> int:
        return {"graph": self.gp, "data": self.dp, "world": self.world}[axis]

    def all_reduce(self, t: torch.Tensor, axis: str = "world") -> torch.Tensor:
        """Σ over the ranks of ``axis`` (``"graph"``, ``"data"`` or ``"world"``)."""
        if self._size(axis) == 1:
            return t
        w = self._wire(t)
        w = w.clone() if w.data_ptr() == t.data_ptr() else w
        dist.all_reduce(w, group=self._group(axis))
        return w.to(t.device)

    def broadcast_(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Rank ``src``'s ``t`` on every rank, in place."""
        if self.world == 1:
            return t
        w = self._wire(t)
        dist.broadcast(w, src=src)
        if w.data_ptr() != t.data_ptr():
            t.copy_(w)
        return t

    def gather_blocks(self, x: torch.Tensor, axis: str = "graph") -> torch.Tensor:
        """Every rank's ``x`` (one shape on all), in rank order along ``axis``,
        concatenated on the first dimension."""
        n = self._size(axis)
        if n == 1:
            return x
        w = self._wire(x)
        parts = [torch.empty_like(w) for _ in range(n)]
        dist.all_gather(parts, w, group=self._group(axis))
        return torch.cat(parts, dim=0).to(x.device)

    def sum_blocks(self, g: torch.Tensor, axis: str = "graph") -> torch.Tensor:
        """The transpose of :meth:`gather_blocks`: ``g`` [n·block, ...] summed
        over the ranks of ``axis``, this rank's block kept. A reduce-scatter
        under NCCL; under gloo, which has none, an all-reduce of the whole
        ``g`` cut to the block (the same sums)."""
        n = self._size(axis)
        if n == 1:
            return g
        pos = self.g if axis == "graph" else (self.d if axis == "data" else self.rank)
        block = g.shape[0] // n
        if self.backend == "nccl":
            out = torch.empty((block,) + tuple(g.shape[1:]), dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(out, g.contiguous(), group=self._group(axis))
            return out
        w = g.detach().cpu().clone()
        dist.all_reduce(w, group=self._group(axis))
        return w[pos * block:(pos + 1) * block].to(g.device)

    def swap(self, sends: dict, recvs: dict) -> dict:
        """Point-to-point along the graph group, all posted at once and waited
        for together (``batch_isend_irecv``), so no ring order can deadlock:
        ``sends`` {graph position: tensor}, ``recvs`` {graph position:
        (shape, dtype)} → {graph position: received tensor on the device}."""
        ops, got = [], {}
        for g_peer, t in sends.items():
            ops.append(dist.P2POp(dist.isend, self._wire(t), self.graph_rank(g_peer),
                                  self.graph_group))
        for g_peer, (shape, dtype) in recvs.items():
            dev = torch.device("cpu") if self.backend == "gloo" else self.device
            got[g_peer] = torch.empty(shape, dtype=dtype, device=dev)
            ops.append(dist.P2POp(dist.irecv, got[g_peer], self.graph_rank(g_peer),
                                  self.graph_group))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return {k: v.to(self.device) for k, v in got.items()}

    def barrier(self):
        if self.world > 1:
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index])
            else:
                dist.barrier()


def make_mesh(dp: Optional[int] = None, gp: int = 1, device="cuda") -> Mesh:
    """The ``dp × gp`` mesh over the initialised process group (``dp=None``:
    every rank left, as the JAX ``make_mesh`` takes every device left).
    Every rank calls it, in the same order as its other group creations:
    it makes one graph group per data row and one data group per graph
    column. ``device``: ``"cuda"`` (the rank's card) or ``"cpu"``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group: run the ranks through "
                           "parallel.launch, or call parallel.init_distributed first")
    world, rank = dist.get_world_size(), dist.get_rank()
    if dp is None:
        if world % gp:
            raise ValueError(f"{world} ranks not divisible by gp={gp}")
        dp = world // gp
    if dp * gp != world:
        raise ValueError(f"mesh {dp}x{gp} needs {dp * gp} ranks, the launch has {world}")
    dev = rank_device(device, rank)
    backend = dist.get_backend()
    graph_group = data_group = None
    for d in range(dp):
        grp = dist.new_group([d * gp + g for g in range(gp)])
        if d == rank // gp:
            graph_group = grp
    for g in range(gp):
        grp = dist.new_group([d * gp + g for d in range(dp)])
        if g == rank % gp:
            data_group = grp
    mesh = Mesh(dp=dp, gp=gp, rank=rank, backend=backend, device=dev,
                graph_group=graph_group, data_group=data_group)
    mesh.barrier()
    return mesh
