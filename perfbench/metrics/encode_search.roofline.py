"""``encode_search.roofline``: the fused exact encode-and-search launches'
share of their roofline. Device time: the launches' kernels in the traced
window (the Eq. 1 encode, the exact scan, the split merge); work: each
traced batch's queries against every stored row of the packed bank, raw
levels in, top-k out."""

from perfbench.harness import readers, work

MATCH = readers.kernels_named("encode_kernel", "tile_scan_kernel",
                              "scan_kernel", "merge_splits_kernel")


def _work(b, sz):
    return work.exact_scan(b.n, sz["base_rows"], sz["dim"], sz["dim"] // 8,
                           4 * sz["num_features"], sz["k"])


def read(run):
    return readers.roofline(run, "exact", MATCH, _work)
