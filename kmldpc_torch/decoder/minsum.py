"""Layered normalised min-sum decoder (port of ``kmldpc_tpu/decoder/minsum.py``).

Posteriors live column-major as [num_col, B].  One iteration sweeps the
layers in order; within a layer every row updates at once:

    v2c   = post[col] - c2v_old
    c2v'  = alpha * sign-excl * min-excl(|v2c|)   (min1/min2, ties to the first slot)
    post[col] += c2v' - c2v_old

* QC path, for lifted codes whose decode graph is quasi-cyclic (the 5G BG2
  code): layer l is block-row l, whose row r meets column ``j*Z + (r+s) % Z``
  for each (block column j, shift s) of the layer.  One ``[d*Z]`` column
  index a layer, built with the tables, gathers the posteriors (JAX's stack
  of rolls) and writes them back.  A layer meets each block column at most
  once, so the write has no conflicts.
* Generic path (other codes, or the 5G code with ``use_qc=False``): padded
  per-layer row tables.  A PEG code's layer is the whole matrix, so one
  layer updates a column several times.  Those updates are added one after the
  other in the layer's flat (row, slot) order, the order in which XLA's CPU
  scatter-add applies them, from a table of each column's update positions
  (``add_pos``).  An atomic ``index_add_`` on CUDA would add them in an
  order that changes from run to run.

Each posterior thus takes its float32 adds in JAX's order, and hard outputs,
iteration counts and convergence are JAX's bit for bit.  Outputs freeze per
codeword at convergence; the generic path also freezes the posteriors and
messages, as JAX's does (the QC path need not: no output reads them).  The
loop stops once the whole batch has converged, tested every
``EXIT_CHECK_EVERY`` iterations as in the flooding decoder.  The soft
syndrome is the min-sum approximation ``sigmoid(sign_prod * min1)`` of
P(row XOR = 0).
"""

from __future__ import annotations

import dataclasses
import numpy as np
import torch

from ..code.ldpc import LDPCCode
from ..utils.trace import count, exit_check
from .bp import DecodeResult, DecoderTables, channel_llr_to_columns, count_failed_checks
from .bp_em import _cn_minsum, _llr_clip

EXIT_CHECK_EVERY = 4  # iterations between tests of whole-batch convergence


def _layer_tables(code: LDPCCode, layer_size: int):
    """Per-layer padded row tables [n_layers, layer_size, dr_max] (NumPy):
    edge index (E = pad), column (num_col = pad) and mask (float32)."""
    n_layers = -(-code.num_row // layer_size)
    drm = code.dr_max
    pad_rows = n_layers * layer_size - code.num_row
    row_edge_idx = np.concatenate(
        [code.row_edge_idx, np.full((pad_rows, drm), code.num_edges, np.int32)])
    row_edge_col = np.concatenate(
        [code.row_edge_col, np.full((pad_rows, drm), code.num_col, np.int32)])
    row_mask = np.concatenate([code.row_mask, np.zeros((pad_rows, drm), bool)])
    shape = (n_layers, layer_size, drm)
    return (row_edge_idx.reshape(shape), row_edge_col.reshape(shape),
            row_mask.reshape(shape).astype(np.float32))


def _qc_layers(code: LDPCCode) -> tuple | None:
    """The quasi-cyclic block structure of the decode graph:
    ``((z, nbc), layer_0, layer_1, ...)``, each layer a tuple of
    ``(block_col, shift)`` pairs (block-row i connects row r to column
    ``block_col*Z + (r + shift) % Z``), or None when the graph is not exactly
    quasi-cyclic with the file's lifting factor."""
    z = code.lifting_factor
    if not z or code.num_row % z or code.num_col % z:
        return None
    br, bc = code.edge_row // z, code.edge_col // z
    r_in, c_in = code.edge_row % z, code.edge_col % z
    nbr, nbc = code.num_row // z, code.num_col // z
    key = br.astype(np.int64) * nbc + bc
    order = np.argsort(key, kind="stable")
    key_s, r_s, c_s = key[order], r_in[order], c_in[order]
    bounds = np.flatnonzero(np.diff(key_s)) + 1
    starts = np.concatenate([[0], bounds])
    ends = np.concatenate([bounds, [key_s.shape[0]]])
    per_layer: list[list[tuple[int, int]]] = [[] for _ in range(nbr)]
    for a, b in zip(starts, ends):
        if b - a != z:
            return None  # a partial block is not a full circulant
        rr, cc = r_s[a:b], c_s[a:b]
        s = (cc - rr) % z
        if not (s == s[0]).all() or np.unique(rr).size != z:
            return None
        k = int(key_s[a])
        per_layer[k // nbc].append((k % nbc, int(s[0])))
    if any(not layer for layer in per_layer):
        return None  # a block-row without circulants
    return ((int(z), int(nbc)), *[tuple(layer) for layer in per_layer])


def _qc_columns(qc: tuple) -> list[np.ndarray]:
    """Per QC layer, the column of each (slot, row): ``[d*Z]``, slot-major."""
    (z, _nbc), *layers = qc
    r = np.arange(z, dtype=np.int64)
    return [np.concatenate([j * z + (r + s) % z for j, s in layer]) for layer in layers]


def _add_positions(l_edge_col: np.ndarray, num_col: int) -> np.ndarray:
    """``[n_layers, K, num_col]``: for each layer and column, the positions
    in the layer's flat (row, slot) order whose deltas add to that column,
    ascending, padded with ``ls*drm`` (a zero row appended to the deltas).
    K is the most updates one layer makes to one column."""
    n_layers, ls, drm = l_edge_col.shape
    flat = l_edge_col.reshape(n_layers, ls * drm).astype(np.int64)
    real = flat < num_col
    k = max((int(np.bincount(f[m], minlength=1).max()) for f, m in zip(flat, real) if m.any()),
            default=0)
    pos = np.full((n_layers, k, num_col), ls * drm, dtype=np.int64)
    for layer, f in enumerate(flat):
        order = np.argsort(f, kind="stable")  # by column, positions ascending
        cols = f[order]
        rank = np.arange(cols.shape[0]) - np.searchsorted(cols, cols, side="left")
        keep = cols < num_col
        pos[layer, rank[keep], cols[keep]] = order[keep]
    return pos


@dataclasses.dataclass(frozen=True)
class MinsumTables:
    """Layered-schedule tables of one code on one device.

    ``l_edge_idx``, ``l_edge_col`` and ``l_mask`` are the JAX package's
    generic layer tables; when ``qc`` is present the decoder takes the QC
    path and they have size zero.  ``qc_cols`` and ``add_pos`` are derived
    from them (:meth:`from_arrays`)."""

    base: DecoderTables
    l_edge_idx: torch.Tensor  # [n_layers, ls, drm] int64, E = pad
    l_edge_col: torch.Tensor  # [n_layers, ls, drm] int64, num_col = pad
    l_mask: torch.Tensor  # [n_layers, ls, drm] f32
    qc: tuple | None
    qc_cols: tuple  # per QC layer: [d*Z] int64 column of each (slot, row)
    add_pos: torch.Tensor  # [n_layers, K, num_col] int64 (see _add_positions)

    @staticmethod
    def from_arrays(base: DecoderTables, l_edge_idx, l_edge_col, l_mask, qc: tuple | None,
                    device: torch.device | str = "cpu") -> "MinsumTables":
        """Build from the JAX package's ``MinsumTables`` fields (anything
        ``np.asarray`` takes) and this package's ``base`` tables."""
        l_edge_col = np.asarray(l_edge_col)
        qc_cols = _qc_columns(qc) if qc is not None else []
        return MinsumTables(
            base=base,
            l_edge_idx=torch.tensor(np.asarray(l_edge_idx).astype(np.int64), device=device),
            l_edge_col=torch.tensor(l_edge_col.astype(np.int64), device=device),
            l_mask=torch.tensor(np.asarray(l_mask).astype(np.float32), device=device),
            qc=qc,
            qc_cols=tuple(torch.tensor(c, device=device) for c in qc_cols),
            add_pos=torch.tensor(_add_positions(l_edge_col, base.num_col), device=device),
        )


def minsum_tables(code: LDPCCode, use_qc: bool = True,
                  device: torch.device | str = "cpu") -> MinsumTables:
    """Tables of ``code`` for the layered schedule, as the JAX package's
    ``minsum_tables`` builds them at its default layering: a layer is Z rows
    for 5G codes (conflict-free block-rows) and ``num_row`` (flooding
    min-sum) for other codes.  A quasi-cyclic graph takes the QC path, with
    zero-size generic tables, unless ``use_qc`` is False."""
    qc = _qc_layers(code) if use_qc else None
    if qc is not None:
        layers = (np.zeros((0, 0, 0), np.int32),) * 2 + (np.zeros((0, 0, 0), np.float32),)
    else:
        layers = _layer_tables(code, code.lifting_factor if code.is_5g else code.num_row)
    return MinsumTables.from_arrays(DecoderTables.from_code(code, device), *layers, qc, device)


def layered_minsum_decode(mt: MinsumTables, chan_llr: torch.Tensor, iter_count: int,
                          alpha: float = 0.75) -> DecodeResult:
    """Layered min-sum decode of [B, tx_len] channel LLRs; batch-major
    outputs over all ``num_col`` columns, as ``flooding_decode_em``'s."""
    decode = _decode_qc if mt.qc is not None else _decode_generic
    return decode(mt, chan_llr.to(torch.float32), iter_count, alpha)


def _result(t: DecoderTables, cc_hat, conv, iters, ss) -> DecodeResult:
    uu_hat = cc_hat[t.info_start : t.info_start + t.code_dim]
    return DecodeResult(uu_hat.T, cc_hat.T, conv, iters, ss.T)


def _decode_qc(mt: MinsumTables, chan_llr: torch.Tensor, iter_count: int,
               alpha: float) -> DecodeResult:
    """QC path: per layer one gather of its posteriors, the check update on
    a [d, Z, B] slab, one conflict-free write back."""
    t = mt.base
    llr_clip = _llr_clip()
    z = mt.qc[0][0]
    b = chan_llr.shape[0]
    dev = chan_llr.device
    post = channel_llr_to_columns(t, chan_llr).t().clone(memory_format=torch.contiguous_format)
    c2v = [torch.zeros((cols.shape[0] // z, z, b), device=dev) for cols in mt.qc_cols]
    cc_hat = torch.zeros((t.num_col, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((t.num_row, b), dtype=torch.float32, device=dev)
    ran = iter_count
    for i in range(iter_count):
        if i > 0 and i % EXIT_CHECK_EVERY == 0 and exit_check(conv):
            ran = i
            break
        ss_parts = []
        for layer, (cols, old) in enumerate(zip(mt.qc_cols, c2v)):
            p = post[cols].reshape(old.shape)
            new, ss_layer = _cn_minsum(p - old, alpha, llr_clip)
            post.index_put_((cols,), (p + (new - old)).reshape(-1, b))
            c2v[layer] = new
            ss_parts.append(ss_layer)
        cc_hat = torch.where(conv[None, :], cc_hat, (post <= 0).to(torch.int8))
        ok = count_failed_checks(t, cc_hat.T) == 0
        iters = iters + (~conv).to(torch.int32)
        conv = conv | ok
        # layer l holds rows l*Z .. (l+1)*Z - 1
        ss = torch.where(conv[None, :], ss, torch.cat(ss_parts))
    count("cw_iters_run", b * ran)
    return _result(t, cc_hat, conv, iters, ss)


def _decode_generic(mt: MinsumTables, chan_llr: torch.Tensor, iter_count: int,
                    alpha: float) -> DecodeResult:
    """Generic path: padded layer tables; c2v stored by edge index with a
    pad row (E), the posteriors with a pad column (num_col)."""
    t = mt.base
    llr_clip = _llr_clip()
    n_layers, ls, drm = mt.l_edge_col.shape
    nc, nr = t.num_col, t.num_row
    b = chan_llr.shape[0]
    dev = chan_llr.device
    llr_col = channel_llr_to_columns(t, chan_llr).T
    post = torch.cat([llr_col, torch.zeros((1, b), device=dev)])  # [nc+1, B]
    c2v = torch.zeros((t.num_edges + 1, b), device=dev)  # [E+1, B]
    zero_row = torch.zeros((1, b), device=dev)
    cc_hat = torch.zeros((nc, b), dtype=torch.int8, device=dev)
    conv = torch.zeros((b,), dtype=torch.bool, device=dev)
    iters = torch.zeros((b,), dtype=torch.int32, device=dev)
    ss = torch.ones((nr, b), dtype=torch.float32, device=dev)
    ran = iter_count
    for i in range(iter_count):
        if i > 0 and i % EXIT_CHECK_EVERY == 0 and exit_check(conv):
            ran = i
            break
        post_new, c2v_new = post, c2v
        ss_layers = []
        for layer in range(n_layers):
            idx = mt.l_edge_idx[layer].reshape(-1)
            mask = mt.l_mask[layer][:, :, None]
            old = c2v_new[idx].reshape(ls, drm, b)
            v2c = post_new[mt.l_edge_col[layer].reshape(-1)].reshape(ls, drm, b) - old
            # a pad slot enters as +1e30, which JAX's masks make of it:
            # sign +1, magnitude 1e30 (the minimum of no row that has an
            # edge); its message is then zeroed
            new, ss_layer = _cn_minsum(
                torch.where(mask > 0, v2c, 1e30).transpose(0, 1), alpha, llr_clip)
            new = new.transpose(0, 1) * mask
            delta = torch.cat([((new - old) * mask).reshape(ls * drm, b), zero_row])
            # each column's updates in flat (row, slot) order; the pad
            # column is never written, so it stays 0 (JAX's scatter-add
            # accumulates pad deltas there and resets it after the sweep)
            acc = post_new[:nc]
            for pos in mt.add_pos[layer]:
                acc = acc + delta[pos]
            post_new = torch.cat([acc, post_new[nc:]])
            # pad slots all write the pad row E; no output reads it
            c2v_new = c2v_new.index_put((idx,), new.reshape(ls * drm, b))
            ss_layers.append(ss_layer)
        ss_new = torch.cat(ss_layers)[:nr]
        cc_hat = torch.where(conv[None, :], cc_hat, (post_new[:nc] <= 0).to(torch.int8))
        ok = count_failed_checks(t, cc_hat.T) == 0
        iters = iters + (~conv).to(torch.int32)
        conv = conv | ok
        post = torch.where(conv[None, :], post, post_new)
        c2v = torch.where(conv[None, :], c2v, c2v_new)
        ss = torch.where(conv[None, :], ss, ss_new)
    count("cw_iters_run", b * ran)
    return _result(t, cc_hat, conv, iters, ss)
