"""Multi-rank runs over ``torch.distributed``: one process per rank.

The counterpart of ``kmldpc_tpu/parallel/distributed.py`` and of the JAX
package's device meshes (``get_mesh``, ``get_mesh_2d``).  Where JAX drives
every device of a host from one process, the port runs one process per
rank, started by ``torchrun`` or by anything that sets torchrun's
environment: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``.  Every collective returns the same values on every rank
of its group, so the ranks take identical stopping decisions with no other
communication.

The backend is ``nccl`` when the ranks run on CUDA and each has a card of
its own, else ``gloo`` (the CPU, or several ranks sharing one card).  Gloo
reduces CUDA tensors by staging them through the host, so ranks sharing a
card check function and memory, not speed.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from ..device import resolve_device


def world_size() -> int:
    """Ranks of the initialised process group, else 1."""
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on rank 0, and in a single-process run."""
    return not dist.is_initialized() or dist.get_rank() == 0


def rank_device(name: str | torch.device = "cuda") -> torch.device:
    """This rank's device: ``"cpu"`` stays the CPU; ``"cuda"`` becomes
    ``cuda:(LOCAL_RANK % device_count)``.  Raises like ``resolve_device``
    when CUDA is asked for and there is none; never gives way to the CPU."""
    dev = torch.device(name)
    if dev.type == "cuda" and dev.index is None:
        resolve_device(dev)  # raises without a card
        local = int(os.environ.get("LOCAL_RANK", "0"))
        dev = torch.device("cuda", local % torch.cuda.device_count())
    return resolve_device(dev)


def choose_backend(device_type: str, world: int, device_count: int) -> str:
    """``nccl`` when every rank has a CUDA card of its own, else ``gloo``.

    NCCL does not put two ranks of one communicator on one card, so ranks
    that share a card, and CPU ranks, take gloo.
    """
    return "nccl" if device_type == "cuda" and world <= device_count else "gloo"


def maybe_initialize(device: str | torch.device = "cuda") -> bool:
    """Join the process group when a launcher set ``WORLD_SIZE`` > 1.

    Returns True when running multi-rank.  Safe to call twice.  The backend
    follows :func:`choose_backend` for this rank's device, which becomes
    the current CUDA device.
    """
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return False
    if dist.is_initialized():
        return True
    dev = rank_device(device)
    count = 0
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        count = torch.cuda.device_count()
    dist.init_process_group(choose_backend(dev.type, world, count), init_method="env://")
    return True


def layout(data_parallel: int, model_parallel: int, world: int,
           batch: int) -> tuple[int, int]:
    """The (ndata, nmodel) layout a config of ``batch`` codewords a
    sub-chunk asks of ``world`` ranks: the JAX harness's choice of mesh
    (``kmldpc_tpu/sim/montecarlo.py:144-194``).

    Model parallel (``model_parallel > 1``) takes ``data_parallel`` data
    rows, or as many as the ranks hold; otherwise ``data_parallel`` data
    shards, or one a rank, and one shard where the batch is smaller than
    that (it runs undivided).  The layout takes the first ranks, as the
    JAX package takes the first devices.  ``ndata`` counts data shards: a
    data-parallel layout runs on :func:`data_ranks` of them, fewer where
    the ranks are fewer than the shards, as JAX's ``get_mesh`` takes the
    devices there are; the shards' draws stay those of one rank a shard.
    A model-parallel layout the ranks cannot hold raises the JAX package's
    words (``get_mesh_2d``) and the ranks to start.
    """
    nmodel = max(1, model_parallel)
    ndata = data_parallel or (max(1, world // nmodel) if nmodel > 1 else world)
    if nmodel > 1 and ndata * nmodel > world:
        raise _too_few_ranks(ndata, nmodel, world)
    if nmodel == 1 and batch < ndata:
        return 1, 1
    return ndata, nmodel


def data_ranks(ndata: int, world: int) -> int:
    """The ranks that run ``ndata`` data shards: the largest divisor of
    ``ndata`` that ``world`` ranks hold (1 in a single process), each
    running ``ndata`` / that many shards in turn."""
    return max(r for r in range(1, min(ndata, world) + 1) if ndata % r == 0)


def _too_few_ranks(ndata: int, nmodel: int, world: int) -> ValueError:
    """The JAX package's words (``get_mesh_2d``), then the ranks to start."""
    need = ndata * nmodel
    return ValueError(
        f"mesh ({ndata} data x {nmodel} model) needs {need} devices, have {world} "
        f"(one rank a device: start {need} ranks, e.g. torchrun --nproc-per-node {need})"
    )


def grid_ranks(ndata: int, nmodel: int) -> tuple[list[list[int]], list[list[int]]]:
    """The ranks of each model row and of each data column of a (data x
    model) layout: ``rank = data_rank * nmodel + model_rank``."""
    rows = [[d * nmodel + m for m in range(nmodel)] for d in range(ndata)]
    return rows, [list(col) for col in zip(*rows)]


class Grid:
    """A (data x model) layout over the first ``ndata * nmodel`` ranks: the
    counterpart of the JAX package's ``get_mesh(ndata)`` and
    ``get_mesh_2d(ndata, nmodel)``, which take the first devices.

    ``rank = data_rank * nmodel + model_rank``: ``model`` is the minor axis,
    so the ranks of one model row are adjacent.  ``model_group`` holds the
    ranks of this rank's data row (they share the row slabs of one batch),
    ``data_group`` those of its model column (they split the batch); each is
    None where it would hold this rank alone.  Ranks beyond the layout are
    idle (``active`` False): they belong to no group and take part in no
    collective of the layout.  Every rank of the launch builds the Grid, as
    ``new_group`` is collective over the default group, and calls
    :meth:`close` when the layout's run ends.
    """

    def __init__(self, ndata: int, nmodel: int = 1) -> None:
        if ndata < 1 or nmodel < 1:
            raise ValueError(f"mesh ({ndata} data x {nmodel} model) needs positive sizes")
        need = ndata * nmodel
        world = world_size()
        if world < need:
            raise _too_few_ranks(ndata, nmodel, world)
        self.ndata, self.nmodel = ndata, nmodel
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.active = self.rank < need
        self.data_rank, self.model_rank = divmod(self.rank, nmodel)
        self.model_group = self.data_group = None
        self._groups: list = []
        if need == 1:
            return
        # new_group is collective: every rank, idle ones too, creates every
        # group, in one order
        rows, cols = grid_ranks(ndata, nmodel)
        for d, ranks in enumerate(rows):
            group = self._new_group(ranks) if nmodel > 1 else None
            if d == self.data_rank:
                self.model_group = group
        for m, ranks in enumerate(cols):
            group = self._new_group(ranks) if ndata > 1 else None
            if m == self.model_rank and self.active:
                self.data_group = group

    def _new_group(self, ranks: list[int]):
        group = dist.new_group(ranks)
        self._groups.append(group)
        return group

    def close(self) -> None:
        """Release the layout's groups (every rank, in one order)."""
        for group in self._groups:
            dist.destroy_process_group(group)
        self._groups.clear()
        self.model_group = self.data_group = None


def all_reduce(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` in place over ``group`` (no-op for None) and return it."""
    if group is not None:
        dist.all_reduce(t, group=group)
    return t


def all_gather_cat(t: torch.Tensor, group, dim: int = 0) -> torch.Tensor:
    """The ranks' ``t`` concatenated along ``dim`` in rank order, on every
    rank of ``group`` (``t`` itself for None).  Gloo gathers CUDA tensors
    itself, staging them through the host, as it sums them."""
    if group is None:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)
