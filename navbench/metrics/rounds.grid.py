"""The solve loop's rounds a step on the gridded map's cell, the mean over the
traced window (the plan results' `rounds`)."""

from navbench import readings


def read(trace):
    return readings.mean_rounds(trace)
