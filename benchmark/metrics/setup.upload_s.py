"""Seconds of the port's uploads (``Executor.timings["upload"]``, the
degree phase's and the job executor's, summed)."""


def read(ctx):
    return ctx["setup"].get("upload")
