"""``queue_wait_p95_ms.live``: the 95th percentile of the server's own
``t_dispatch - t_submit`` stamps over the traced window's requests: how
long a request waited in the queue for a slot."""

from perfbench.harness import readers


def read(run):
    return readers.queue_wait_p95_ms(run)
