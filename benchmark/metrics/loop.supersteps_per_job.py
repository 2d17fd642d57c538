"""The mean supersteps of the window's jobs (``Executor.iteration``
after each job; the convergence flush not counted)."""


def read(ctx):
    s = ctx["window"]["supersteps"]
    return sum(s) / len(s)
