"""Share of the traced sweep in which no activity runs on the device."""


def read(trace, ctx):
    if trace.window_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
