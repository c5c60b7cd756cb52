"""Device idle while the host is inside the chain's ``decode`` label, in
any span within it, in milliseconds per 1000 codewords of the traced
sweep: the trace's idle gaps named ``decode``, or ``decode/<span>``, by
what the host was in at each gap's middle."""


def read(trace, ctx):
    idle = [s for host, s in trace.idle_by_host.items()
            if host == "decode" or host.startswith("decode/")]
    if not idle or not trace.blocks:
        return None
    return sum(idle) * 1e3 / (trace.blocks / 1000)
