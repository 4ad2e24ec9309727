"""``batch_fill.live``: the mean number of requests a dispatched batch
held, over the largest batch, for the traced window's batches."""

from perfbench.harness import readers


def read(run):
    return readers.batch_fill(run)
