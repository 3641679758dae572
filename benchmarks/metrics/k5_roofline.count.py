"""k5_roofline.count: kernel K5 (csrc/hash_append.cu) against its byte bound:
the bytes its launches in the window need at the least (keys written,
packed bases, N mask and lengths read once; shbench/kernels.py) over the
card's published HBM bandwidth, divided by K5's device time by kernel name
in the trace, as a percentage."""

from shbench import kernels, peaks


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    t = tr.op_seconds(kernels.K5_NAME)
    if t <= 0:
        return None
    k = int(ctx["config"]["k"])
    nbytes = sum(kernels.k5_bytes(j["batches"], j["batch_rows"],
                                  j["row_len"], k) for j in ctx["jobs"])
    return 100.0 * nbytes / peaks.HBM_BYTES_PER_S / t
