"""Mean number of iterations ``System.optimize_density`` returned, over
the window's answered requests: the program's own count."""


def read(ctx):
    its = [a["iters"] for a in ctx.answers if "iters" in a]
    return sum(its) / len(its) if its else None
