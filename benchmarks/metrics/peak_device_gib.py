"""peak_device_gib: torch.cuda.max_memory_allocated over the window, GiB."""


def read(ctx):
    return ctx["peak_bytes"] / float(1 << 30) if ctx["peak_bytes"] else None
