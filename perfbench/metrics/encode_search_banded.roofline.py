"""``encode_search_banded.roofline``: the fused banded encode-and-search
launches' share of their roofline. Device time: the launches' kernels in
the traced window (the Eq. 1 encode, the banded scan, the merge); work:
each traced batch's queries against the union of their precursor windows
in the packed bank, raw levels in, top-k out."""

from perfbench.harness import readers, work

MATCH = readers.kernels_named("encode_kernel", "banded_scan_kernel",
                              "merge_splits_kernel")


def _work(b, sz):
    return work.banded_scan(b.n, b.plan.starts, b.plan.lens, sz["dim"],
                            sz["dim"] // 8, 4 * sz["num_features"], sz["k"])


def read(run):
    return readers.roofline(run, "banded", MATCH, _work)
