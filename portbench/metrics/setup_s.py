"""Seconds from the process's start to the window's: imports, kernel
builds, writing the inputs, partitions, weights and the warm-up."""


def read(rec):
    return rec["setup_s"]
