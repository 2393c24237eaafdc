"""The pass's walker kernel (not its prescan) ns a walked (8-lane block, row)
pair on the scanned map's cell: its traced time over the program's
"banded_pass_rows"."""

from navbench import counters


def read(trace):
    return counters.dirty_row_ns(trace)
