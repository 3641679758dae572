"""assembly_s: the window's seconds over the assemblies (pipeline jobs)
completed in it; every job that started in the window ran to its end."""


def read(ctx):
    return ctx["window_s"] / len(ctx["jobs"])
