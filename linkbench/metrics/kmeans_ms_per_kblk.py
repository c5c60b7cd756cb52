"""Device milliseconds of the kernels launched under the chain's ``kmeans``
label, per 1000 codewords of the traced sweep.  Kernel K1 is launched
through ``ctypes``; a program that launches it inside the span ``k1`` ties
it to the label, one that does not leaves the label without device time
and gives no reading."""


def read(trace, ctx):
    return trace.ms_per_kblk("kmeans")
