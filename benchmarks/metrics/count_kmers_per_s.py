"""count_kmers_per_s: k-mers (read windows) counted in the window over the
window's seconds; every job that started in the window ran to its end."""


def read(ctx):
    return ctx["kmers"] / ctx["window_s"]
