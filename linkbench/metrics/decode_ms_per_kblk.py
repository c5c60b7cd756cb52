"""Device milliseconds of the kernels launched under the chain's ``decode``
label, per 1000 codewords of the traced sweep."""


def read(trace, ctx):
    return trace.ms_per_kblk("decode")
