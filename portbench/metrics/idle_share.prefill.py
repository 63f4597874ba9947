"""The traced window's share in which no kernel, copy or set ran on the
device."""
import readers


def read(run):
    return readers.idle_share(run)
