"""Stored edges x the supersteps every job of the window ran (the
convergence flush not counted), over the window's seconds, in 1e9."""


def read(ctx):
    w = ctx["window"]
    return ctx["stored_edges"] * sum(w["supersteps"]) / w["seconds"] / 1e9
