"""``delta_scan.roofline``: the banded scan over the appended int8 delta
rows, as a share of its roofline. Device time: the banded scan kernel's
launches over int8 lanes (its first template argument 1), which the trace
tells apart from the packed base's (0); the merge after it is not counted.
Work: each traced batch's raw bipolar queries against the union of their
windows in the delta's own precursor-sorted rows, top-k out."""

from perfbench.harness import readers, work

MATCH = readers.kernels_named("banded_scan_kernel", mode="1")


def _work(b, sz):
    p = b.plan.delta
    return work.banded_scan(b.n, p.starts, p.lens, sz["dim"], sz["dim"],
                            sz["dim"], sz["k"])


def read(run):
    return readers.roofline(run, "merged", MATCH, _work)
