"""The share of the rows a dirty-driven csrc/banded_pass.cu launch walked on
the scanned map's cell: the program's "banded_pass_rows" over every (8-lane
block, row) pair of the field, each launch."""

from navbench import counters


def read(trace):
    return counters.dirty_rows_share(trace)
