"""The per-chunk simulation chain for B codewords (port of
``kmldpc_tpu/sim/chain.py``):

    bits -> encode -> map -> channel -> [K1 k-means + ambiguity metric]
         -> soft demap -> exact two-phase decode (flooding, or layered
            min-sum; on the card, float32 sum-product flooding is kernel
            K2 on a regular code and K3 on an irregular one, the whole batch
            in one call, as the decoder itself decides)
         -> error counters

It is split into a random front end (bits to channel outputs, drawn from one
``torch.Generator``) and a deterministic back end
``backend(params, uu, yr, yi, hr_true, hi_true, var) -> ChunkResult``, so a
test can inject the JAX package's channel outputs into the port's back end.
Known-h runs the same back end without detection.  PyTorch runs eagerly;
the harness (montecarlo.py) calls the chain once per sub-chunk, and the
multi-point runner runs several whole launches (one per SNR point) per
call.  Each layer runs under a label (frontend, kmeans, metric, demap,
decode, counters; ``utils/trace.py``): a ``record_function`` span while a
``torch.profiler`` records, so a trace splits the chain's time by layer,
and the stage the decoders' counters count under.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from ..code.ldpc import LDPCCode
from ..config import Config
from ..device import resolve_device
from ..decoder.bp import DecodeResult
from ..decoder.bp_em import flooding_decoder, two_phase_generic
from ..decoder.minsum import layered_minsum_decode
from ..detect.kmeans import add_diagnostics, make_blind_estimator
from ..detect.kmeans_cuda import make_blind_estimator_cuda
from ..detect.metric import complement_closed, make_ambiguity_selector
from ..io.constellation import Constellation
from ..ops.channel import fading_awgn_channel
from ..ops.encode import make_encoder
from ..ops.modem import ModemTables, make_mapper, make_soft_demapper
from ..ops.source import chunk_seed, make_generator, random_bits
from ..params import ChainParams, make_chain_params
from ..utils.trace import count, label


class ChunkResult(NamedTuple):
    """Counters of one chunk (reference: SourceSink, sourcesink.cc:29-47).

    Tensors stay on the chain's device; the harness reads them.
    """

    err_bit: torch.Tensor  # 0-d int
    err_blk: torch.Tensor  # 0-d int
    tot_bit: int
    tot_blk: int
    err_bit_sq: torch.Tensor  # 0-d f32: sum over blocks of (bit errors)^2
    metrics: torch.Tensor  # [B, 4] f32 |metric| table; zeros if known-h
    iters: torch.Tensor  # 0-d f32: mean BP iterations executed
    # k-means inspection surface, (yr, yi, cl_r, cl_i, idx, h4_r, h4_i,
    # hr_true, hi_true) when ChainSpec.kmeans_dump is set (blind only), else
    # (); the harness writes it with utils.records.dump_kmeans
    kmeans_diag: tuple = ()
    # per-block debug surface (ChainSpec.debug_blocks > 0): (hr_true,
    # hi_true), plus (h4_r, h4_i) when blind; else ()
    debug: tuple = ()
    # the final decode's per-codeword DecodeResult; () in histogram mode
    raw: tuple = ()
    # whether the final decode ran each codeword to its own convergence
    # (kernel K2 or K3), as its decoder reports: the harness counts those
    # iterations, which the kernel ran exactly, at consume
    per_codeword: bool = False


@dataclasses.dataclass(frozen=True)
class ChainSpec:
    """Static recipe for one simulation configuration."""

    code: LDPCCode
    constellation: Constellation
    known_h: bool
    fading: bool
    metric_type: bool
    metric_iter: int
    max_iter: int
    encoder_active: bool
    kmeans_iters: int = 20
    kmeans_anchor: str = "max"
    # "auto" and "pallas" select kernel K1 for CUDA tensors (the plain
    # version for CPU tensors); "jax" selects the plain version explicitly.
    kmeans_impl: str = "auto"
    phase1_iters: int = 3
    tile: int = 0  # 0 = batch // 8 (at least 8)
    # final decode: "flooding" (sum-product, the reference's),
    # "flooding-minsum" (normalised min-sum with minsum_alpha) or
    # "layered-minsum" (decoder/minsum.py, params.ms)
    schedule: str = "flooding"
    minsum_alpha: float = 0.75
    # c2v message storage of the flooding final decode: "float32" or
    # "bfloat16" (node arithmetic float32); the layered schedule and the
    # metric decodes ignore it, as in the JAX package
    dtype: str = "float32"
    # metric decodes: "flooding" (sum-product, as the reference) or "match"
    # (the final decode's schedule)
    metric_schedule: str = "flooding"
    # skip the -ĥ / -jĥ candidates where they tie +ĥ / +jĥ exactly
    # (detect/metric.py complement_closed)
    metric_prune: bool = False
    # histogram mode: keep the metric table, skip the final decode
    histogram: bool = False
    # surface the k-means clusters and assignments (blind only)
    kmeans_dump: bool = False
    # surface true h and the ĥ candidates for the harness's per-block lines
    debug_blocks: int = 0

    @staticmethod
    def from_config(cfg: Config, code: LDPCCode, constellation: Constellation) -> "ChainSpec":
        """Spec of ``cfg``.  The rank layout (``[tpu] data_parallel``,
        ``model_parallel``) is the harness's to choose, not the chain's."""
        tpu = cfg.tpu
        return ChainSpec(
            code=code,
            constellation=constellation,
            known_h=cfg.decoder.true_h_arg,
            fading=tpu.fading,
            metric_type=cfg.xcodec.metric_type,
            metric_iter=cfg.xcodec.metric_iter,
            max_iter=cfg.ldpc.max_iter,
            encoder_active=cfg.ldpc.active,
            kmeans_impl=tpu.kmeans_impl,
            phase1_iters=tpu.phase1_iters,
            tile=tpu.tile,
            schedule=tpu.schedule,
            minsum_alpha=tpu.minsum_alpha,
            dtype=tpu.dtype,
            metric_schedule=tpu.metric_schedule,
            metric_prune=tpu.metric_prune,
            histogram=cfg.histogram.enable,
            kmeans_dump=bool(tpu.kmeans_dump_dir) and not cfg.decoder.true_h_arg,
            debug_blocks=tpu.debug_blocks,
        )


def build_frontend_fn(
    spec: ChainSpec, batch: int, device: torch.device | str
) -> Callable[[ChainParams, torch.Generator, torch.Tensor], tuple]:
    """``frontend(params, gen, var) -> (uu, yr, yi, hr_true, hi_true)``.

    Draws the info bits, then h, then the noise, all from ``gen``.
    """
    code = spec.code
    tables = ModemTables.from_constellation(spec.constellation, device)
    encode = make_encoder(code, active=spec.encoder_active)
    map_bits = make_mapper(tables)

    def frontend(params: ChainParams, gen: torch.Generator, var: torch.Tensor):
        with label("frontend"):
            return draw(params, gen, var)

    def draw(params: ChainParams, gen: torch.Generator, var: torch.Tensor):
        uu = random_bits(gen, (batch, code.code_dim), device)
        if not spec.encoder_active:
            uu = torch.zeros_like(uu)  # binaryldpccodec.cc:156-161
        _, cc_tx = encode(uu, params.gen_t)
        xr, xi = map_bits(cc_tx)
        yr, yi, hr, hi = fading_awgn_channel(gen, xr, xi, torch.sqrt(var), spec.fading)
        return uu, yr, yi, hr, hi

    return frontend


def build_backend_fn(
    spec: ChainSpec,
    batch: int,
    device: torch.device | str,
    metric_fn: Callable | None = None,
    decode: Callable[[torch.Tensor, int], DecodeResult] | None = None,
) -> Callable[..., ChunkResult]:
    """``backend(params, uu, yr, yi, hr_true, hi_true, var) -> ChunkResult``.

    Two injection points, the JAX package's model-parallel runner's:
    ``metric_fn(t, bit_p0, chan_llr) -> metric`` replaces the selector's
    metric computation (it wins over ``metric_schedule``), and
    ``decode(chan_llr, iter_count) -> DecodeResult`` replaces the final
    two-phase decode.  With neither, the chain is the single-device one.
    """
    code = spec.code
    tables = ModemTables.from_constellation(spec.constellation, device)
    demap = make_soft_demapper(tables)
    if spec.kmeans_impl in ("auto", "pallas"):
        estimate = make_blind_estimator_cuda(tables, spec.kmeans_iters, spec.kmeans_anchor)
    elif spec.kmeans_impl == "jax":
        estimate = make_blind_estimator(tables, spec.kmeans_iters, spec.kmeans_anchor)
    else:
        raise ValueError(f"unknown kmeans_impl {spec.kmeans_impl!r}")
    if spec.kmeans_dump:
        estimate = add_diagnostics(estimate, tables)
    if spec.schedule not in ("flooding", "layered-minsum", "flooding-minsum"):
        raise ValueError(f"unknown schedule {spec.schedule!r}")
    if spec.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown tpu.dtype {spec.dtype!r}")
    msg_dtype = torch.float32 if spec.dtype == "float32" else torch.bfloat16
    if spec.metric_schedule not in ("flooding", "match"):
        raise ValueError(f"unknown metric_schedule {spec.metric_schedule!r}")
    if spec.metric_prune and spec.histogram:
        raise ValueError(
            "metric_prune is incompatible with histogram mode (the "
            "metric table would carry duplicated pairs)"
        )
    if spec.metric_prune and not complement_closed(code, spec.constellation):
        raise ValueError(
            "metric_prune requires a complement-closed constellation "
            "and even-degree check rows (the shipped QPSK table + PEG codes); "
            f"{spec.constellation.num_points}-point table / code "
            f"{code.name!r} do not qualify"
        )
    layered = spec.schedule == "layered-minsum"
    cn_rule = "minsum" if spec.schedule == "flooding-minsum" else "sumprod"
    match = spec.metric_schedule == "match"

    def decoder(tabs, llr, msg_dtype=torch.float32):
        """The schedule's batch decoder of ``llr``'s rows on ``tabs`` (``params.ms``
        if layered, else ``params.dec``); ``msg_dtype`` applies to flooding only."""
        if layered:
            return lambda x, it: layered_minsum_decode(tabs, x, it, spec.minsum_alpha)
        return flooding_decoder(tabs, llr, cn_rule, spec.minsum_alpha, msg_dtype)

    select = None
    if not spec.known_h or spec.histogram:
        # "match" decodes the metric with the final schedule, in float32
        select = make_ambiguity_selector(
            code, tables, spec.metric_type, spec.metric_iter,
            decode=(lambda t, llr, it: decoder(t, llr)(llr, it))
            if match and metric_fn is None else None,
            prune_complement=spec.metric_prune, metric_fn=metric_fn,
        )
    tile = spec.tile or max(8, batch // 8)

    def backend(params: ChainParams, uu, yr, yi, hr_true, hi_true, var) -> ChunkResult:
        var = torch.as_tensor(var, dtype=torch.float32, device=yr.device)
        tabs = params.ms if layered else params.dec
        sel_tabs = tabs if match else params.dec
        kmeans_diag = debug = raw = ()
        per_codeword = False
        if spec.known_h:
            if spec.histogram:
                # one metric per block, over the single candidate true h;
                # columns 1-3 are NaN, dropped by the histogram writer
                with label("metric"):
                    h1_r = torch.stack([hr_true] * 4, dim=1)
                    h1_i = torch.stack([hi_true] * 4, dim=1)
                    _, _, m4, _ = select(sel_tabs, yr, yi, h1_r, h1_i, var)
                    nan = torch.full((batch, 3), float("nan"), device=yr.device)
                    metrics = torch.cat([m4[:, :1], nan], dim=1)
            else:
                metrics = torch.zeros((batch, 4), dtype=torch.float32, device=yr.device)
                with label("demap"):
                    _, chan_llr = demap(yr, yi, hr_true, hi_true, var)
        else:
            with label("kmeans"):
                h4_r, h4_i, *diag = estimate(yr, yi)
                count("rows", yr.shape[0])
            if diag:
                kmeans_diag = (yr, yi, *diag, h4_r, h4_i, hr_true, hi_true)
            with label("metric"):
                _, _, metrics, chan_llr = select(sel_tabs, yr, yi, h4_r, h4_i, var)
        if spec.debug_blocks > 0:
            debug = (hr_true, hi_true) if spec.known_h else (hr_true, hi_true, h4_r, h4_i)
        if spec.histogram:
            # histogram mode skips the final decode: only the metrics matter
            uu_hat = torch.zeros_like(uu)
            iters = torch.zeros((), dtype=torch.float32, device=yr.device)
        else:
            with label("decode"):
                if decode is not None:
                    raw = decode(chan_llr, spec.max_iter)
                else:
                    final = decoder(tabs, chan_llr, msg_dtype)
                    raw = two_phase_generic(final, chan_llr, spec.max_iter,
                                            phase1_iters=spec.phase1_iters, tile=tile)
                    per_codeword = getattr(final, "per_codeword", False)
            uu_hat, iters = raw.uu_hat, raw.iters.to(torch.float32).mean()
        with label("counters"):
            errs = (uu != uu_hat).sum(dim=1, dtype=torch.int32)  # [B]
            errs_f = errs.to(torch.float32)
            return ChunkResult(
                err_bit=errs.sum(),
                err_blk=(errs > 0).sum(),
                tot_bit=batch * code.code_dim,
                tot_blk=batch,
                err_bit_sq=(errs_f * errs_f).sum(),
                metrics=metrics,
                iters=iters,
                kmeans_diag=kmeans_diag,
                debug=debug,
                raw=raw,
                per_codeword=per_codeword,
            )

    return backend


def build_chain_fn(
    spec: ChainSpec,
    batch: int,
    device: torch.device | str,
    metric_fn: Callable | None = None,
    decode: Callable[[torch.Tensor, int], DecodeResult] | None = None,
) -> Callable[[ChainParams, torch.Generator, torch.Tensor], ChunkResult]:
    """``chain(params, gen, var) -> ChunkResult``: front end + back end
    (``metric_fn`` and ``decode`` as in :func:`build_backend_fn`)."""
    frontend = build_frontend_fn(spec, batch, device)
    backend = build_backend_fn(spec, batch, device, metric_fn, decode)

    def chain(params: ChainParams, gen: torch.Generator, var: torch.Tensor) -> ChunkResult:
        return backend(params, *frontend(params, gen, var), var)

    return chain


def _concat(rs: list[ChunkResult]) -> ChunkResult:
    """One launch's result from its sub-chunks' results: counters summed,
    per-block tensors concatenated, iterations averaged."""
    def cat(parts):
        if not parts[0]:
            return ()
        cols = [torch.cat(col) for col in zip(*parts)]
        return type(parts[0])(*cols) if hasattr(parts[0], "_fields") else tuple(cols)

    return ChunkResult(
        err_bit=sum(r.err_bit for r in rs),
        err_blk=sum(r.err_blk for r in rs),
        tot_bit=sum(r.tot_bit for r in rs),
        tot_blk=sum(r.tot_blk for r in rs),
        err_bit_sq=sum(r.err_bit_sq for r in rs),
        metrics=torch.cat([r.metrics for r in rs]),
        iters=torch.stack([r.iters for r in rs]).mean(),
        kmeans_diag=cat([r.kmeans_diag for r in rs]),
        debug=cat([r.debug for r in rs]),
        raw=cat([r.raw for r in rs]),
        per_codeword=rs[0].per_codeword,
    )


def _stack(rs: list[ChunkResult]) -> ChunkResult:
    """Launch results stacked on a new leading [m] axis, field by field."""
    def stack(vals):
        if isinstance(vals[0], tuple):
            if not vals[0]:
                return ()
            cols = [stack(list(col)) for col in zip(*vals)]
            return type(vals[0])(*cols) if hasattr(vals[0], "_fields") else tuple(cols)
        if torch.is_tensor(vals[0]):
            return torch.stack(vals)
        return torch.tensor(vals)

    return ChunkResult(*(stack(list(col)) for col in zip(*rs)))


def launch_fn(
    chain: Callable[[ChainParams, torch.Generator, torch.Tensor], ChunkResult],
    params: ChainParams,
    device: torch.device,
    seed: int,
    subs: range,
) -> Callable[[float, int, float], ChunkResult]:
    """``run_launch(snr, launch, var)``: ``chain`` once per sub-chunk
    ``sub`` in ``subs``, each from a generator seeded with
    ``chunk_seed(seed, snr, launch, sub)``; the counters of the sub-chunks
    are summed, per-block tensors (metrics, the k-means and debug surfaces,
    the decode results) concatenated, iters averaged."""

    def run_launch(snr: float, launch: int, var: float) -> ChunkResult:
        var_t = torch.tensor(var, dtype=torch.float32, device=device)
        rs = [
            chain(params, make_generator(chunk_seed(seed, snr, launch, sub), device), var_t)
            for sub in subs
        ]
        return rs[0] if len(rs) == 1 else _concat(rs)

    return run_launch


def make_chunk_runner(
    spec: ChainSpec,
    batch: int,
    chunks_per_launch: int = 1,
    device: torch.device | str = "cuda",
    seed: int = 0,
) -> Callable[[float, int, float], ChunkResult]:
    """``run_launch(snr, launch, var) -> ChunkResult`` over
    ``chunks_per_launch`` sub-chunks (0 .. n-1) of ``batch`` codewords, as
    :func:`launch_fn` runs them; per-block tensors are [n*batch, ...].

    ``device`` is resolved by ``resolve_device``: "cuda" without a card
    raises.
    """
    n = max(1, chunks_per_launch)
    device = resolve_device(device)
    params = make_chain_params(spec.code, device, spec.schedule)
    run_launch = launch_fn(build_chain_fn(spec, batch, device), params, device, seed, range(n))
    run_launch.params = params  # type: ignore[attr-defined]
    run_launch.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    return run_launch


def multi_point_fn(
    launch: Callable[[float, int, float], ChunkResult], m: int
) -> Callable[[list[tuple[float, int]], list[float]], ChunkResult]:
    """``run_launches(points, vars)``: ``m`` calls of ``launch`` a call, one
    a slot, stacked on a leading [m] axis (the JAX package's ``lax.scan``
    over slots)."""

    def run_launches(points: list[tuple[float, int]], vars_: list[float]) -> ChunkResult:
        if len(points) != m or len(vars_) != m:
            raise ValueError(f"expected {m} slots, got {len(points)} points, {len(vars_)} vars")
        return _stack([launch(snr, n, float(v)) for (snr, n), v in zip(points, vars_)])

    run_launches.num_slots = m  # type: ignore[attr-defined]
    return run_launches


def make_multi_point_runner(
    spec: ChainSpec,
    batch: int,
    chunks_per_launch: int = 1,
    m: int = 2,
    device: torch.device | str = "cuda",
    seed: int = 0,
) -> Callable[[list[tuple[float, int]], list[float]], ChunkResult]:
    """``run_launches(points, vars) -> ChunkResult`` advancing ``m`` whole
    launches per call, one slot each: ``points[j] = (snr_j, launch_j)``
    with noise variance ``vars[j]``.

    Every field of the result has a leading [m] axis.  Slot j runs exactly
    the launch that ``make_chunk_runner(...)(snr_j, launch_j, vars[j])``
    runs, from the same ``chunk_seed`` generators, so it is bitwise that
    sequential launch.  The slots run one after the other, on one shared
    ``ChainParams``.
    """
    launch = make_chunk_runner(spec, batch, chunks_per_launch, device, seed)
    run_launches = multi_point_fn(launch, m)
    run_launches.params = launch.params  # type: ignore[attr-defined]
    run_launches.blocks_per_launch = launch.blocks_per_launch  # type: ignore[attr-defined]
    return run_launches
