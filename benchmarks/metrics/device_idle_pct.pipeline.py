"""device_idle_pct: the share of the traced window (first job's start to last
job's end) in which no kernel, copy or fill ran on the card."""


def read(ctx):
    return ctx["trace"].idle_pct if ctx["trace"] is not None else None
