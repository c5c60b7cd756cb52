"""The final decode's share of its roofline, in %: its least time
(``roofline.decode_least_s``: the check rule's operations for the
iterations each traced codeword's result says it needed, or its LLRs read
and decided bits written once) over the device time of the kernels
launched under the chain's ``decode`` label.  Phase 1's discarded work and
phase 2's re-decodes are not counted: they are waste."""

from linkbench.roofline import decode_least_s


def read(trace, ctx):
    seconds = trace.by_label.get("decode")
    if not seconds or not trace.iters or not ctx["ops_per_s"]:
        return None
    code = ctx["link"].code
    least = decode_least_s(ctx["cell"].tables["tpu"]["schedule"], code.num_edges, trace.iters,
                           trace.blocks, code.tx_len, code.info_bits, ctx["ops_per_s"])
    return None if least is None else 100.0 * least / seconds
