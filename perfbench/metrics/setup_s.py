"""``setup_s``: seconds from the start of the process to the window: the
inputs made, the library encoded and registered, the bank built, the
kernels built (the first run in a checkout) and every shape warmed up."""


def read(run):
    return run.setup_s
