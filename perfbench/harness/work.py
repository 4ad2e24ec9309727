"""What a served batch's search needs, and the chip's published peaks.

The work is counted from the batch's shape and its window plan, never from
the kernels' own tiles:

* bytes: the bank rows the batch's queries need, each read once (every
  stored row for the exact route; the union of the real queries' windows,
  band by band, for the banded routes), plus the queries in and the
  results out (k int32 rows and k int32 scores a query);
* operations: 2 * D for each query-candidate pair (a +-1 multiply and an
  add a dimension).

A roofline share sets the least time at the peaks, the larger of bytes
over bandwidth and operations over the int8 rate, against the measured
device time.
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Published dense peaks (NVIDIA's data sheet), keyed by a part of the name
# that ``torch.cuda.get_device_name`` gives
PEAKS = {
    "H100": {"hbm_bytes_per_s": 3.35e12, "int8_ops_per_s": 1.979e15,
             "source": "NVIDIA H100 SXM data sheet, dense, 700 W"},
}


def peaks(device_name: str) -> dict | None:
    for key, p in PEAKS.items():
        if key in device_name:
            return p
    return None


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)

    def bound_s(self, p: dict) -> float:
        return max(self.bytes / p["hbm_bytes_per_s"],
                   self.ops / p["int8_ops_per_s"])


ZERO = Work(0.0, 0.0)


def result_bytes(n: int, k: int) -> int:
    return n * k * 8


def exact_scan(n: int, num_rows: int, dim: int, row_bytes: int,
               query_bytes: int, k: int) -> Work:
    """``n`` queries against every one of ``num_rows`` stored rows."""
    return Work(bytes=float(num_rows * row_bytes + n * query_bytes
                            + result_bytes(n, k)),
                ops=float(2 * dim * n * num_rows))


def union_rows(starts: np.ndarray, lens: np.ndarray) -> int:
    """Rows in the union of ``[start, start + len)`` intervals, band by
    band ((bands, queries) arrays)."""
    total = 0
    for s, ln in zip(np.asarray(starts), np.asarray(lens)):
        live = ln > 0
        if not live.any():
            continue
        s = s[live].astype(np.int64)
        e = s + ln[live].astype(np.int64)
        order = np.argsort(s, kind="stable")
        s, e = s[order], e[order]
        reach = np.maximum.accumulate(e)
        # a new run starts where the interval begins past all before it
        new = np.ones(s.shape[0], bool)
        new[1:] = s[1:] > reach[:-1]
        run_id = np.cumsum(new) - 1
        run_s = s[new]
        run_e = np.zeros(run_s.shape[0], np.int64)
        np.maximum.at(run_e, run_id, e)
        total += int((run_e - run_s).sum())
    return total


def banded_scan(n: int, starts: np.ndarray, lens: np.ndarray, dim: int,
                row_bytes: int, query_bytes: int, k: int) -> Work:
    """``n`` real queries (the plan's first ``n`` columns) against the
    rows of their windows."""
    s, ln = np.asarray(starts)[:, :n], np.asarray(lens)[:, :n]
    return Work(bytes=float(union_rows(s, ln) * row_bytes + n * query_bytes
                            + result_bytes(n, k)),
                ops=float(2 * dim * int(ln.astype(np.int64).sum())))


def roofline_pct(work: Work, device_s: float, p: dict | None
                 ) -> float | None:
    """The least time at the peaks over the measured device time, in %;
    None where nothing was measured."""
    if p is None or device_s <= 0 or work.bytes <= 0:
        return None
    return 100.0 * work.bound_s(p) / device_s
