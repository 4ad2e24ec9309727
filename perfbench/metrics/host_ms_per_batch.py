"""``host_ms_per_batch``: the host's milliseconds of work per dispatched
batch in the traced window (see ``harness.readers.host_ms_per_batch``)."""

from perfbench.harness import readers


def read(run):
    return readers.host_ms_per_batch(run)
