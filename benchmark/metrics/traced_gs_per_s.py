"""Ground states completed per second of the traced run's window, over
all its requests: the host-bound rate of a cell whose end-to-end metric
is its device time (its spans add a synchronisation after each call and
its first requests run under the profiler)."""


def read(ctx):
    if not ctx.completed or ctx.loop_s <= 0:
        return None
    return ctx.completed / ctx.loop_s
