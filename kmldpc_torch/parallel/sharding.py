"""Data-parallel launches: the batch split over the ranks of a ``Grid``'s
data axis (port of ``kmldpc_tpu/parallel/sharding.py``).

A launch of ``n`` sub-chunks of ``batch`` codewords over ``D`` data shards
runs, in shard ``s``, sub-chunks ``s*n .. s*n+n-1`` of ``batch / D``
codewords each, from the generators ``chunk_seed(seed, snr, launch, sub)``.
So the D-shard launch draws exactly what the single-device
``make_chunk_runner(spec, batch / D, D * n)`` launch draws: its error
counters are bitwise that launch's (``err_bit_sq`` too while its sums stay
below 2^24), whatever D is.  The shards run on the ``R`` data ranks of a
``Grid`` (R divides D, one shard a rank where the ranks hold them all):
data rank ``r`` runs shards ``r*D/R .. (r+1)*D/R - 1`` in turn, so a
``data_parallel = D`` config runs bitwise on fewer ranks, one process
included.  The counters are summed over the data group, so every rank
holds the global ones and takes the same stopping decision.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..device import resolve_device
from ..params import make_chain_params
from ..sim.chain import ChainSpec, ChunkResult, build_chain_fn, launch_fn, multi_point_fn
from .distributed import Grid, all_gather_cat, all_reduce


def _gather(surface: tuple, group) -> tuple:
    """A per-block tuple surface gathered over ``group`` in rank order."""
    if not surface:
        return surface
    cols = [all_gather_cat(a, group) for a in surface]
    return type(surface)(*cols) if hasattr(surface, "_fields") else tuple(cols)


def reduce_launch(res: ChunkResult, grid: Grid, gather: bool) -> ChunkResult:
    """One data rank's launch result made global: error counters summed over
    the data group, ``iters`` averaged, totals scaled to the whole batch.

    ``gather`` also concatenates the per-block surfaces the harness reads
    (metrics, debug, k-means) over the data group in rank order, which is
    shard order; the decode results, and whether the final decode ran per
    codeword, stay rank-local.
    """
    group = grid.data_group
    counts = all_reduce(torch.stack([res.err_bit, res.err_blk]).to(torch.int64), group)
    floats = all_reduce(torch.stack([res.err_bit_sq, res.iters]).to(torch.float32), group)
    metrics, debug, kmeans_diag = res.metrics, res.debug, res.kmeans_diag
    if gather:
        metrics = all_gather_cat(metrics, group)
        debug = _gather(debug, group)
        kmeans_diag = _gather(kmeans_diag, group)
    return res._replace(
        err_bit=counts[0],
        err_blk=counts[1],
        tot_bit=res.tot_bit * grid.ndata,
        tot_blk=res.tot_blk * grid.ndata,
        err_bit_sq=floats[0],
        metrics=metrics,
        iters=floats[1] / grid.ndata,
        kmeans_diag=kmeans_diag,
        debug=debug,
    )


def sharded_launch_fn(
    spec: ChainSpec, chain, params, grid: Grid, n: int, device: torch.device, seed: int,
    shards: int,
) -> Callable[[float, int, float], ChunkResult]:
    """``run_launch(snr, launch, var)``: the ``n`` sub-chunks of each of
    this data rank's ``shards / grid.ndata`` shards of ``chain``, reduced
    over the data group by :func:`reduce_launch`.  The per-block surfaces
    are gathered when the harness writes them (histogram files, debug
    lines, k-means dumps)."""
    subs_a_rank = shards // grid.ndata * n
    subs = range(grid.data_rank * subs_a_rank, (grid.data_rank + 1) * subs_a_rank)
    local = launch_fn(chain, params, device, seed, subs)
    gather = spec.histogram or spec.debug_blocks > 0 or spec.kmeans_dump

    def run_launch(snr: float, launch: int, var: float) -> ChunkResult:
        return reduce_launch(local(snr, launch, var), grid, gather)

    return run_launch


def make_sharded_chunk_runner(
    spec: ChainSpec,
    batch: int,
    grid: Grid,
    chunks_per_launch: int = 1,
    device: torch.device | str = "cuda",
    seed: int = 0,
    shards: int = 0,
) -> Callable[[float, int, float], ChunkResult]:
    """``run_launch(snr, launch, var) -> ChunkResult`` over ``grid``'s data
    axis, in ``shards`` data shards (0: one a data rank), which the data
    ranks must divide.  ``batch`` is the global sub-chunk size and must
    divide by the shards; counters and totals come back global on every
    rank."""
    shards = shards or grid.ndata
    if shards % grid.ndata != 0:
        raise ValueError(f"{shards} data shards do not divide over {grid.ndata} data ranks")
    if batch % shards != 0:
        raise ValueError(f"batch {batch} not divisible by mesh size {shards}")
    n = max(1, chunks_per_launch)
    device = resolve_device(device)
    params = make_chain_params(spec.code, device, spec.schedule)
    chain = build_chain_fn(spec, batch // shards, device)
    run_launch = sharded_launch_fn(spec, chain, params, grid, n, device, seed, shards)
    run_launch.params = params  # type: ignore[attr-defined]
    run_launch.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    return run_launch


def make_sharded_multi_point_runner(
    spec: ChainSpec,
    batch: int,
    grid: Grid,
    chunks_per_launch: int = 1,
    m: int = 2,
    device: torch.device | str = "cuda",
    seed: int = 0,
    shards: int = 0,
) -> Callable[[list[tuple[float, int]], list[float]], ChunkResult]:
    """Data parallel and SNR-point folding composed: ``run_launches(points,
    vars)`` advances ``m`` whole launches a call, each one sharded launch
    of :func:`make_sharded_chunk_runner`, so slot j is bitwise the
    sequential sharded launch of ``points[j]``."""
    launch = make_sharded_chunk_runner(spec, batch, grid, chunks_per_launch, device, seed,
                                       shards)
    run_launches = multi_point_fn(launch, m)
    run_launches.params = launch.params  # type: ignore[attr-defined]
    run_launches.blocks_per_launch = launch.blocks_per_launch  # type: ignore[attr-defined]
    return run_launches
