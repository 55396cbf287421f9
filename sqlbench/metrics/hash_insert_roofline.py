"""The hash-insert kernel's share of its roofline (``roofline.py``) over
the traced window's calls."""

from sqlbench import readers


def read(run):
    return readers.roofline_share(run, "hash_insert")
