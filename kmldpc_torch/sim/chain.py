"""The per-chunk simulation chain for B codewords (port of
``kmldpc_tpu/sim/chain.py``):

    bits -> encode -> map -> channel -> [K1 k-means + ambiguity metric]
         -> soft demap -> exact two-phase flooding decode -> error counters

It is split into a random front end (bits to channel outputs, drawn from one
``torch.Generator``) and a deterministic back end
``backend(params, uu, yr, yi, hr_true, hi_true, var) -> ChunkResult``, so a
test can inject the JAX package's channel outputs into the port's back end.
Known-h runs the same back end without detection.  PyTorch runs eagerly;
the harness (montecarlo.py) calls the chain once per sub-chunk.  Each layer
runs under a ``record_function`` label (frontend, kmeans, metric, demap,
decode, counters), so a ``torch.profiler`` trace splits the chain's time
by layer.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch
from torch.profiler import record_function

from ..code.ldpc import LDPCCode
from ..config import Config
from ..decoder.bp_em import flooding_decode_em, flooding_decode_two_phase
from ..detect.kmeans import make_blind_estimator
from ..detect.kmeans_cuda import make_blind_estimator_cuda
from ..detect.metric import complement_closed, make_ambiguity_selector
from ..io.constellation import Constellation
from ..ops.channel import fading_awgn_channel
from ..ops.encode import make_encoder
from ..ops.modem import ModemTables, make_mapper, make_soft_demapper
from ..ops.source import chunk_seed, make_generator, random_bits
from ..params import ChainParams, make_chain_params


def unported(knob: str, item: str) -> NotImplementedError:
    """The error for a configuration knob the port does not implement yet."""
    return NotImplementedError(
        f"{knob} is not ported to kmldpc_torch yet (ROADMAP.md Queue 1, {item!r})"
    )


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
    # final-decode check rule: "flooding" (sum-product, the reference's) or
    # "flooding-minsum" (normalised min-sum with minsum_alpha)
    schedule: str = "flooding"
    minsum_alpha: float = 0.75
    # metric decodes: "flooding" (sum-product, as the reference) or "match"
    # (the final decode's check rule)
    metric_schedule: str = "flooding"
    # skip the -ĥ / -jĥ candidates where they tie +ĥ / +jĥ exactly
    # (detect/metric.py complement_closed)
    metric_prune: bool = False

    @staticmethod
    def from_config(cfg: Config, code: LDPCCode, constellation: Constellation) -> "ChainSpec":
        """Spec of ``cfg``; raises NotImplementedError for unported knobs."""
        tpu = cfg.tpu
        if tpu.schedule == "layered-minsum":
            raise unported(f"[tpu] schedule = {tpu.schedule!r}", "layered min-sum")
        if tpu.dtype != "float32":
            raise unported(f"[tpu] dtype = {tpu.dtype!r}", "bf16")
        if cfg.histogram.enable:
            raise unported("[histogram] enable", "snr_fold, checkpoints, histogram, dumps")
        if tpu.kmeans_dump_dir:
            raise unported("[tpu] kmeans_dump_dir", "snr_fold, checkpoints, histogram, dumps")
        if tpu.debug_blocks:
            raise unported("[tpu] debug_blocks", "snr_fold, checkpoints, histogram, dumps")
        if tpu.model_parallel > 1:
            raise unported("[tpu] model_parallel", "multi-device")
        if tpu.data_parallel > 1:
            raise unported("[tpu] data_parallel > 1", "multi-device")
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
            metric_schedule=tpu.metric_schedule,
            metric_prune=tpu.metric_prune,
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
        with record_function("frontend"):
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
    spec: ChainSpec, batch: int, device: torch.device | str
) -> Callable[..., ChunkResult]:
    """``backend(params, uu, yr, yi, hr_true, hi_true, var) -> ChunkResult``."""
    code = spec.code
    tables = ModemTables.from_constellation(spec.constellation, device)
    demap = make_soft_demapper(tables)
    if spec.kmeans_impl in ("auto", "pallas"):
        estimate = make_blind_estimator_cuda(tables, spec.kmeans_iters, spec.kmeans_anchor)
    elif spec.kmeans_impl == "jax":
        estimate = make_blind_estimator(tables, spec.kmeans_iters, spec.kmeans_anchor)
    else:
        raise ValueError(f"unknown kmeans_impl {spec.kmeans_impl!r}")
    if spec.schedule not in ("flooding", "flooding-minsum"):
        raise ValueError(f"unknown schedule {spec.schedule!r}")
    if spec.metric_schedule not in ("flooding", "match"):
        raise ValueError(f"unknown metric_schedule {spec.metric_schedule!r}")
    if spec.metric_prune and not complement_closed(code, spec.constellation):
        raise ValueError(
            "metric_prune requires a complement-closed constellation "
            "and even-degree check rows (the shipped QPSK table + PEG codes); "
            f"{spec.constellation.num_points}-point table / code "
            f"{code.name!r} do not qualify"
        )
    cn_rule = "minsum" if spec.schedule == "flooding-minsum" else "sumprod"
    mdecode = None
    if spec.metric_schedule == "match" and cn_rule == "minsum":
        def mdecode(t, llr, it):
            return flooding_decode_em(t, llr, it, cn_rule, spec.minsum_alpha)
    select = None
    if not spec.known_h:
        select = make_ambiguity_selector(
            code, tables, spec.metric_type, spec.metric_iter, decode=mdecode,
            prune_complement=spec.metric_prune,
        )
    tile = spec.tile or max(8, batch // 8)

    def backend(params: ChainParams, uu, yr, yi, hr_true, hi_true, var) -> ChunkResult:
        var = torch.as_tensor(var, dtype=torch.float32, device=yr.device)
        if spec.known_h:
            metrics = torch.zeros((batch, 4), dtype=torch.float32, device=yr.device)
            with record_function("demap"):
                _, chan_llr = demap(yr, yi, hr_true, hi_true, var)
        else:
            with record_function("kmeans"):
                h4_r, h4_i = estimate(yr, yi)
            with record_function("metric"):
                _, _, metrics, chan_llr = select(params.dec, yr, yi, h4_r, h4_i, var)
        with record_function("decode"):
            res = flooding_decode_two_phase(
                params.dec, chan_llr, spec.max_iter, phase1_iters=spec.phase1_iters,
                tile=tile, cn_rule=cn_rule, alpha=spec.minsum_alpha,
            )
        with record_function("counters"):
            errs = (uu != res.uu_hat).sum(dim=1, dtype=torch.int32)  # [B]
            errs_f = errs.to(torch.float32)
            return ChunkResult(
                err_bit=errs.sum(),
                err_blk=(errs > 0).sum(),
                tot_bit=batch * code.code_dim,
                tot_blk=batch,
                err_bit_sq=(errs_f * errs_f).sum(),
                metrics=metrics,
                iters=res.iters.to(torch.float32).mean(),
            )

    return backend


def build_chain_fn(
    spec: ChainSpec, batch: int, device: torch.device | str
) -> Callable[[ChainParams, torch.Generator, torch.Tensor], ChunkResult]:
    """``chain(params, gen, var) -> ChunkResult``: front end + back end."""
    frontend = build_frontend_fn(spec, batch, device)
    backend = build_backend_fn(spec, batch, device)

    def chain(params: ChainParams, gen: torch.Generator, var: torch.Tensor) -> ChunkResult:
        return backend(params, *frontend(params, gen, var), var)

    return chain


def make_chunk_runner(
    spec: ChainSpec,
    batch: int,
    chunks_per_launch: int = 1,
    device: torch.device | str = "cpu",
    seed: int = 0,
) -> Callable[[float, int, float], ChunkResult]:
    """``run_launch(snr, launch, var) -> ChunkResult`` over
    ``chunks_per_launch`` sub-chunks of ``batch`` codewords.

    Sub-chunk ``sub`` of launch ``launch`` at ``snr`` draws from a generator
    seeded with ``chunk_seed(seed, snr, launch, sub)``; the counters of the
    sub-chunks are summed, metrics stacked to [n*batch, 4], iters averaged.
    """
    n = max(1, chunks_per_launch)
    params = make_chain_params(spec.code, device)
    chain = build_chain_fn(spec, batch, device)

    def run_launch(snr: float, launch: int, var: float) -> ChunkResult:
        var_t = torch.tensor(var, dtype=torch.float32, device=device)
        rs = [
            chain(params, make_generator(chunk_seed(seed, snr, launch, sub), device), var_t)
            for sub in range(n)
        ]
        if n == 1:
            return rs[0]
        return ChunkResult(
            err_bit=sum(r.err_bit for r in rs),
            err_blk=sum(r.err_blk for r in rs),
            tot_bit=sum(r.tot_bit for r in rs),
            tot_blk=sum(r.tot_blk for r in rs),
            err_bit_sq=sum(r.err_bit_sq for r in rs),
            metrics=torch.cat([r.metrics for r in rs]),
            iters=torch.stack([r.iters for r in rs]).mean(),
        )

    run_launch.params = params  # type: ignore[attr-defined]
    run_launch.blocks_per_launch = n * batch  # type: ignore[attr-defined]
    return run_launch
