"""Seconds from the process's start of set-up to the window: torch and
CUDA, the kernel library (built by a checkout's first run), the programs
made on the device and one warm call (host clock)."""


def read(ctx):
    return ctx.setup_s
