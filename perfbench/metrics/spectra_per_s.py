"""``spectra_per_s``: spectra answered (top-k and FDR decision) inside
the window, over the window's length; an answer that failed does not
count."""


def read(run):
    return run.completed / run.seconds if run.seconds > 0 else None
