"""``scanned_fraction``: the share of the bank that the open search's plan
prices a batch's scan at (the server's per-batch counter), averaged over
the window's batches."""

import numpy as np


def read(run):
    fr = [b.plan.scanned_fraction for b in run.batches if b.plan is not None]
    return float(np.mean(fr)) if fr else None
