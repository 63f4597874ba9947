"""The peak share of the KV pool's pages in use in the window, sampled
from metrics()['free_pages_group0'] at each dispatch."""


def read(run):
    if not run.pool_free or not run.num_pages:
        return None
    return 100.0 * (1 - min(run.pool_free) / run.num_pages)
