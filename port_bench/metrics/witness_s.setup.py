"""Seconds of the assignment filled in set-up (the tree, the program's
``set_witness`` and its batched trace), timed by the harness."""


def read(run):
    return run.witness_setup_s
