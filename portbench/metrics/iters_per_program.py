"""Mean Newton iterations over the window's programs, as the solver
counts them (num_iterations): the solve loop and its mu update."""


def read(ctx):
    return float(ctx.programs.iterations.mean())
