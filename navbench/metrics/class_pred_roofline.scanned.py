"""csrc/class_pred.cu's share of its roofline, in %, on the scanned map's
cell: the frozen bound of its int8 launches (navbench/counts.py on the
field's own shape) over their measured time."""

from navbench import readings


def read(trace):
    return readings.pred_roofline(trace)
