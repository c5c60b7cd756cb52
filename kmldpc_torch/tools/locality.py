"""Graph locality of the decoder's gathers: a reverse-Cuthill-McKee (RCM)
relabelling of the Tanner graph against the original labelling.

The counterpart of the JAX side's ``tools/locality.py``, with its keys and
fields:

    python -m kmldpc_torch.tools.locality [--json out.json] [--code FILE]
        [--batch B] [--iters N] [--device cuda|cpu]

Each iteration of the slot-major flooding core gathers the check-to-variable
messages into column order and the posteriors into row slots, at the
graph's (random, for PEG codes) indices.  RCM makes both index streams
near-banded; belief propagation is invariant to relabelling, so any change
in µs per iteration comes from the gathers alone.  The tool prints the band
statistics of both labellings, checks that the relabelled graph decodes
noiseless codewords back to themselves, then times µs per iteration of the
``minsum`` and ``sumprod`` rules on the original and the RCM tables with
``microbench.steady``, median of 3 passes.  Classic (unpunctured) codes
only: the 5G convention pins the first 2Z column labels.  The default
device is ``cuda``; without a card that is an error, never a switch to the
CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

from ..device import resolve_device
from .microbench import ASSETS, _save, device_name, seeded_normal, steady


def rcm_relabel(code):
    """Relabel rows and columns of the Tanner graph by reverse Cuthill-McKee.

    Returns ``(new_code, rinv, cinv)``: ``rinv[old_row]`` and
    ``cinv[old_col]`` are the new labels, and ``new_code`` is the same
    bipartite graph with near-banded adjacency.  For the decoder's tables
    only: the encoder and ``info_slice`` keep the original labelling.
    """
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    from ..code.ldpc import _build_adjacency

    if code.punct != 0:
        raise ValueError(f"{code.name}: classic (unpunctured) codes only")
    nr, nc = code.num_row, code.num_col
    r = code.edge_row.astype(np.int64)
    c = code.edge_col.astype(np.int64) + nr  # bipartite: columns after rows
    n = nr + nc
    ones = np.ones(r.shape[0])
    adj = coo_matrix(
        (np.concatenate([ones, ones]),
         (np.concatenate([r, c]), np.concatenate([c, r]))),
        shape=(n, n),
    ).tocsr()
    order = np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))
    row_nodes = order[order < nr]  # old row ids in RCM order
    col_nodes = order[order >= nr] - nr  # old column ids in RCM order
    rinv = np.empty(nr, np.int64)
    rinv[row_nodes] = np.arange(nr)
    cinv = np.empty(nc, np.int64)
    cinv[col_nodes] = np.arange(nc)
    adj_t = _build_adjacency(
        rinv[code.edge_row.astype(np.int64)],
        cinv[code.edge_col.astype(np.int64)],
        nr, nc,
    )
    return dataclasses.replace(code, **adj_t), rinv, cinv


def band_stats(code) -> dict:
    """Mean and max |scaled row - column| over the edges: the gathers'
    locality."""
    r = code.edge_row.astype(np.float64) * (code.num_col / code.num_row)
    c = code.edge_col.astype(np.float64)
    d = np.abs(r - c)
    return {"mean_band": round(float(d.mean()), 1),
            "max_band": round(float(d.max()), 1)}


def check_relabelled(code, rcm, cinv: np.ndarray, device: torch.device) -> None:
    """Four noiseless codewords, their columns relabelled, decode on the
    RCM tables in one sweep back to themselves; raises otherwise."""
    from ..decoder import DecoderTables, flooding_decode_em

    rng = np.random.default_rng(5)
    uu = rng.integers(0, 2, size=(4, code.code_dim)).astype(np.uint8)
    words = np.stack([code.encode_reference(u) for u in uu])
    llr = np.where(words == 0, 9.0, -9.0).astype(np.float32)
    llr_rcm = np.empty_like(llr)
    llr_rcm[:, cinv] = llr  # the new label of old column j is cinv[j]
    res = flooding_decode_em(DecoderTables.from_code(rcm, device),
                             torch.from_numpy(llr_rcm).to(device), 5)
    back = res.cc_hat.cpu().numpy()[:, cinv]
    if not np.array_equal(back, words) or not bool(res.converged.all()):
        raise RuntimeError("the RCM relabelling is not the same code")


def run(code_file: str = "PEG8064regular0.5.txt", batch: int = 1024, iters: int = 20,
        passes: int = 3, device: torch.device | str = "cuda", n1: int = 6,
        n2: int | None = None, json_path: str | None = None) -> dict:
    """Band statistics, the sanity decode and the timed rows; returns the
    results dict."""
    from ..code import load_code
    from ..decoder import DecoderTables, flooding_decode_em

    device = resolve_device(device)
    name = device_name(device)
    print(f"locality: device={name}", file=sys.stderr)
    code = load_code(os.path.join(ASSETS, code_file))
    rcm, _, cinv = rcm_relabel(code)
    results: dict = {"device": name}
    for label, cc in (("orig", code), ("rcm", rcm)):
        results[f"band/{label}"] = band_stats(cc)
        print(f"band/{label}: {results[f'band/{label}']}", file=sys.stderr)
    _save(results, json_path)

    check_relabelled(code, rcm, cinv, device)
    print("sanity: RCM graph decodes the same codewords (1-sweep converge)", file=sys.stderr)

    tables = (("orig", DecoderTables.from_code(code, device)),
              ("rcm", DecoderTables.from_code(rcm, device)))
    stem = code_file.split(".")[0]
    for cn_rule in ("minsum", "sumprod"):
        for label, tabs in tables:
            def call(i: int, tabs=tabs, cn_rule=cn_rule) -> torch.Tensor:
                llr = 0.3 * seeded_normal(7 << 32 | i, (batch, code.num_col), device)
                return flooding_decode_em(tabs, llr, iters, cn_rule=cn_rule).iters.sum()

            sec, spread = steady(call, n1, n2, passes)
            us = sec / iters * 1e6
            key = f"locality/{stem}/{cn_rule}/{label}"
            results[key] = {"us_per_iter": round(us, 1),
                            "spread_pct": round(spread, 1),
                            "batch": batch, "iters": iters}
            _save(results, json_path)
            print(f"{key}: {us:.0f} us/iter ±{spread:.1f}%", file=sys.stderr)
    return results


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(prog="kmldpc_torch.tools.locality",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("--json", default=None)
    ap.add_argument("--code", default="PEG8064regular0.5.txt")
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    results = run(args.code, args.batch, args.iters, device=args.device, json_path=args.json)
    print(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
