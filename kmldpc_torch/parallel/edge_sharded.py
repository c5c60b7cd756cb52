"""Row-sharded flooding BP: the message state split over a ``Grid``'s model
axis (port of ``kmldpc_tpu/parallel/edge_sharded.py``).

The check rows, and with them the edges, are split into contiguous slabs
over the model ranks: model rank m holds ``c2v [drm, nr_pad / M, B]``.
PEG8064 at B = 1024 holds 24,192 edges x 1024 x 4 B = 99 MB of float32
c2v state, so each of M ranks holds about 1/M of it.  Each iteration:

* every rank adds its local c2v into a partial column sum ``[nc, B]``
  (``index_add_``) and ONE ``all_reduce`` over the model group gives every
  rank the full variable-node posterior;
* the hard decision, then the local syndrome slab, whose unsatisfied
  counts ``[B]`` take one more (small) ``all_reduce``;
* the local check update through the masked check-node rule of
  ``decoder/bp_em.py`` (pad slots count as sign +1, phi 0, no minimum).

The column sums are exact: every message is rounded to a grid of 2^-40
(``_FIX_SCALE``) and summed as an int64, locally and across the ranks, then
rounded once to float32.  Integer sums do not depend on their order, so
the posterior does not depend on the order of ``index_add_``'s atomics on
a card, nor on the ring order of the all-reduce, which for gloo changes
with the tensor's size.  The decoder is therefore deterministic, the
posterior is identical on every model rank, and a codeword's trajectory
does not depend on its batch neighbours, so the two-phase schedule is
bitwise the single-phase one.  Against the single-device decoder, which
adds a column's float32 messages one after the other, the posterior
differs by rounding only: decisions, convergence and iterations agree on
the tests' seeds, soft syndromes to rtol 1e-3, as in the JAX package.

Collectives must match on every rank of a model group, or the group
deadlocks.  Every loop bound and early exit here comes from all-reduced
values: ``conv`` is built from the all-reduced unsatisfied counts, so the
decoder's exit test (every ``exit_check_every`` iterations) and
``two_phase_generic``'s count of unconverged codewords, which set how many
slab decodes (and so collectives) run, are the same on every model rank.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..code.ldpc import LDPCCode
from ..decoder.bp import DecodeResult, DecoderTables
from ..decoder.bp_em import _batch_major, _cn, _insert_punct, _llr_clip, two_phase_generic
from ..device import resolve_device
from ..params import make_chain_params
from ..sim.chain import ChainSpec, ChunkResult, build_chain_fn
from ..utils.trace import count, exit_check
from .distributed import Grid, all_gather_cat, all_reduce
from .sharding import sharded_launch_fn

# messages are summed exactly on this grid: |c2v| <= LLR_CLIP ~ 27.6, so a
# column of d edges sums below d * 2^45, far inside int64, and converts to
# float64 exactly while d < 2^8
_FIX_SCALE = 2.0**40


def _row_slab_tables(t: DecoderTables, nmodel: int) -> tuple[torch.Tensor, torch.Tensor, int]:
    """Row-slab tables, padded so ``num_row`` divides by ``nmodel``.

    Returns (row_col [nr_pad, drm] int64 with num_col = pad slot,
    rmask [nr_pad, drm] float32, nr_pad).  Pad rows are all pad slots: they
    gather the +1.0 pad posterior, never fail a check, and get messages 0.
    """
    row_col = t.row_edge_col.cpu().numpy()
    rmask = t.row_mask.cpu().numpy().astype(np.float32)
    nr, drm = row_col.shape
    nr_pad = -(-nr // nmodel) * nmodel
    if nr_pad != nr:
        pad = nr_pad - nr
        row_col = np.concatenate([row_col, np.full((pad, drm), t.num_col, row_col.dtype)])
        rmask = np.concatenate([rmask, np.zeros((pad, drm), np.float32)])
    return torch.from_numpy(row_col.astype(np.int64)), torch.from_numpy(rmask), nr_pad


class _Slab:
    """One model rank's row slab of a code's graph, on its device."""

    def __init__(self, t: DecoderTables, grid: Grid, device: torch.device) -> None:
        row_col, rmask, nr_pad = _row_slab_tables(t, grid.nmodel)
        nrd = nr_pad // grid.nmodel
        rows = slice(grid.model_rank * nrd, (grid.model_rank + 1) * nrd)
        self.t, self.group = t, grid.model_group
        self.row_col = row_col[rows].to(device)  # [nrD, drm]
        self.cols_sm = self.row_col.T.reshape(-1).contiguous()  # [drm * nrD], slot-major
        self.mask = rmask[rows].T[:, :, None].contiguous().to(device)  # [drm, nrD, 1]

    def failed_checks(self, bits: torch.Tensor) -> torch.Tensor:
        """Failed checks [B] int32 of a [B, num_col] 0/1 word over all rows:
        the local slab's count, summed over the model group.  Pad slots
        gather the appended 0 column."""
        zero = torch.zeros((bits.shape[0], 1), dtype=torch.int8, device=bits.device)
        per_row = torch.cat([bits.to(torch.int8), zero], dim=1)[:, self.row_col]
        parity = per_row.sum(dim=-1, dtype=torch.int32) % 2
        return all_reduce(parity.sum(dim=-1, dtype=torch.int32), self.group)

    def decode_cols(
        self, llr_col: torch.Tensor, iter_count: int, cn_rule: str, alpha: float,
        exit_check_every: int = 4,
    ) -> tuple[torch.Tensor, ...]:
        """The slab decoder on replicated column-major LLRs [num_col, B].

        Returns (cc_hat [num_col, B], converged [B], iters [B],
        soft_syndrome of the local rows [nrD, B]).
        """
        llr_clip = _llr_clip()
        t = self.t
        nc, b = t.num_col, llr_col.shape[1]
        drm, nrd = self.mask.shape[:2]
        dev = llr_col.device
        c2v = torch.zeros((drm, nrd, b), dtype=torch.float32, device=dev)
        cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
        conv = torch.zeros((b,), dtype=torch.bool, device=dev)
        iters = torch.zeros((b,), dtype=torch.int32, device=dev)
        ss = torch.ones((nrd, b), dtype=torch.float32, device=dev)
        ones = torch.ones((1, b), dtype=torch.float32, device=dev)
        ran = iter_count
        for i in range(iter_count):
            # conv comes from all-reduced counts: every model rank exits together
            if i > 0 and i % exit_check_every == 0 and exit_check(conv):
                ran = i
                break
            # --- exact partial column sums, ONE all-reduce -> full posterior ---
            fixed = torch.round(c2v * _FIX_SCALE).to(torch.int64).reshape(-1, b)
            partial = torch.zeros((nc + 1, b), dtype=torch.int64, device=dev)
            partial.index_add_(0, self.cols_sm, fixed)
            colsum = all_reduce(partial[:nc], self.group)
            post = llr_col + (colsum.to(torch.float64) / _FIX_SCALE).to(torch.float32)
            cc_hat = torch.where(conv[None, :], cc_hat, (post <= 0).to(torch.int8))
            # --- local syndrome slab; unsatisfied counts summed over the group ---
            post_edge = torch.cat([post, ones])[self.cols_sm].reshape(drm, nrd, b)
            parity = (post_edge <= 0).sum(dim=0, dtype=torch.int32) % 2
            unsat = all_reduce(parity.sum(dim=0, dtype=torch.int32), self.group)
            iters = iters + (~conv).to(torch.int32)
            conv = conv | (unsat == 0)
            # --- local check update; pad slots masked ---
            c2v_new, ss_new = _cn(post_edge - c2v, cn_rule, alpha, llr_clip, self.mask)
            c2v = c2v_new * self.mask
            ss = torch.where(conv[None, :], ss, ss_new)
        count("cw_iters_run", b * ran)
        return cc_hat, conv, iters, ss

    def decode(self, chan_llr: torch.Tensor, iter_count: int, cn_rule: str,
               alpha: float) -> DecodeResult:
        """Batch-major decode of [B, tx_len] LLRs; the soft syndrome holds
        the local rows only ([B, nrD])."""
        t = self.t
        llr_col = _insert_punct(t, chan_llr.to(torch.float32).T.contiguous())
        cc_hat, conv, iters, ss = self.decode_cols(llr_col, iter_count, cn_rule, alpha)
        uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
        return _batch_major(DecodeResult(uu_hat, cc_hat, conv, iters, ss))

    def full_syndrome(self, res: DecodeResult) -> DecodeResult:
        """``res`` with the soft syndrome of every row, gathered over the
        model group in rank order ([B, num_row])."""
        ss = all_gather_cat(res.soft_syndrome, self.group, dim=1)[:, : self.t.num_row]
        return res._replace(soft_syndrome=ss)


def _final_decoder(slab: _Slab, cn_rule: str, alpha: float, phase1_iters: int,
                   tile: int) -> Callable[[torch.Tensor, int], DecodeResult]:
    """``decode(chan_llr, iter_count)`` on the slab, under the exact
    two-phase schedule when ``phase1_iters > 0`` (tile 0 = B // 8, at least
    8), with the full soft syndrome."""

    def one_phase(llr: torch.Tensor, it: int) -> DecodeResult:
        return slab.decode(llr, it, cn_rule, alpha)

    def decode(chan_llr: torch.Tensor, iter_count: int) -> DecodeResult:
        if phase1_iters <= 0:
            res = one_phase(chan_llr, iter_count)
        else:
            b = chan_llr.shape[0]
            res = two_phase_generic(one_phase, chan_llr, iter_count, phase1_iters,
                                    tile or max(8, b // 8))
        return slab.full_syndrome(res)

    return decode


def make_edge_sharded_decoder(
    code: LDPCCode,
    grid: Grid,
    cn_rule: str = "sumprod",
    alpha: float = 0.75,
    phase1_iters: int = 0,
    tile: int = 0,
    device: torch.device | str = "cuda",
) -> Callable[[torch.Tensor, int], DecodeResult]:
    """Row-sharded flooding decoder over ``grid``'s model axis.

    ``decode(chan_llr [B, tx], iter_count) -> DecodeResult``: the interface
    and semantics of ``flooding_decode_em`` (punctured columns included),
    called on every rank of a model group with the same LLRs; every rank
    gets the whole result.  ``phase1_iters > 0`` runs the exact two-phase
    schedule with phase-2 tiles of ``tile`` codewords (0 = B // 8): bitwise
    the single-phase decode.
    """
    if cn_rule not in ("sumprod", "minsum"):
        raise ValueError(f"unknown cn_rule {cn_rule!r}")
    device = resolve_device(device)
    t = DecoderTables.from_code(code, device)
    slab = _Slab(t, grid, device)
    decode = _final_decoder(slab, cn_rule, alpha, phase1_iters, tile)
    decode.tables = t  # type: ignore[attr-defined]
    decode.num_shards = grid.nmodel  # type: ignore[attr-defined]
    return decode


def _slab_metric_fn(spec: ChainSpec, slab: _Slab) -> Callable:
    """The ambiguity metric on the row slab, for ``make_ambiguity_selector``'s
    ``metric_fn``: the classic hard metric counts failed checks of the
    inverted hard decision; the soft metric sums log soft syndromes of the
    local rows (pad rows add log 1 = 0); the 5G hard metric counts failed
    checks of the decoded word.  Each ends in one all-reduce over the model
    group.  The metric decodes run ``metric_iter`` single-phase slab
    iterations, with min-sum under ``metric_schedule = "match"`` and
    flooding min-sum, else sum-product."""
    needs_decode = spec.metric_type or spec.code.is_5g
    match = spec.metric_schedule == "match" and spec.schedule == "flooding-minsum"
    cn_rule = "minsum" if match else "sumprod"

    def metric_fn(t, bit_p0: torch.Tensor, chan_llr: torch.Tensor) -> torch.Tensor:
        if not needs_decode:
            rr = (bit_p0 > 0.5).to(torch.int8)  # NOTE: P(bit=0) > 0.5 -> 1
            return slab.failed_checks(rr).to(torch.float32)
        res = slab.decode(chan_llr, spec.metric_iter, cn_rule, spec.minsum_alpha)
        if spec.metric_type:
            return all_reduce(torch.log(res.soft_syndrome).sum(dim=-1), slab.group)
        return slab.failed_checks(res.cc_hat).to(torch.float32)

    return metric_fn


def make_model_parallel_chunk_runner(
    spec: ChainSpec,
    batch: int,
    grid: Grid,
    chunks_per_launch: int = 1,
    device: torch.device | str = "cuda",
    seed: int = 0,
) -> Callable[[float, int, float], ChunkResult]:
    """Chunk runner over a (data x model) ``grid``: the front end is data
    parallel, the metric decodes and the final decode row-sharded over the
    model axis.

    Data rank r draws the sub-chunks of the data-parallel runner
    (parallel/sharding.py), and every model rank of its row draws the same
    ones, so K1 and the demap run replicated on the model ranks.  The
    metric stage runs on the slab (:func:`_slab_metric_fn`), the final
    decode is the two-phase slab decode (``phase1_iters`` / ``tile`` from
    the spec).  The counters are identical on the model ranks of a data
    row, so they are summed over the data group only: summing over the
    model group too would multiply every count by ``nmodel``.

    The layered min-sum schedule has no row-sharded form (its QC layers
    are block rows, not slabs); histogram and k-means dump modes are
    diagnostic paths that need no model parallelism.
    """
    ndata = grid.ndata
    if spec.histogram:
        raise ValueError("model_parallel does not support histogram mode")
    if spec.kmeans_dump:
        raise ValueError("model_parallel does not support kmeans_dump")
    if spec.schedule == "layered-minsum":
        raise ValueError(
            "model_parallel requires a flooding schedule "
            '("flooding" or "flooding-minsum"); the layered min-sum QC '
            "fast path has no row-sharded formulation"
        )
    if spec.schedule not in ("flooding", "flooding-minsum"):
        raise ValueError(f"unknown schedule {spec.schedule!r}")
    if spec.dtype != "float32":
        raise ValueError(
            "model_parallel decodes in float32 only "
            f"(got tpu.dtype {spec.dtype!r}); the row-sharded core keeps "
            "its c2v state f32"
        )
    cn_rule = "minsum" if spec.schedule == "flooding-minsum" else "sumprod"
    if batch % ndata != 0:
        raise ValueError(f"batch {batch} not divisible by data axis {ndata}")
    local_batch = batch // ndata
    n = max(1, chunks_per_launch)
    device = resolve_device(device)
    params = make_chain_params(spec.code, device, spec.schedule)
    slab = _Slab(params.dec, grid, device)
    final = _final_decoder(slab, cn_rule, spec.minsum_alpha, spec.phase1_iters,
                           spec.tile or max(8, local_batch // 8))
    metric_fn = None if spec.known_h else _slab_metric_fn(spec, slab)
    chain = build_chain_fn(spec, local_batch, device, metric_fn=metric_fn, decode=final)
    run_launch = sharded_launch_fn(spec, chain, params, grid, n, device, seed, grid.ndata)
    run_launch.params = params  # type: ignore[attr-defined]
    run_launch.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    run_launch.num_row_shards = grid.nmodel  # type: ignore[attr-defined]
    return run_launch
