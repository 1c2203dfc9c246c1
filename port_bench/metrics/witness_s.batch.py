"""Seconds a request of the program's ``set_witness`` over a fresh batch,
timed by the harness."""


def read(run):
    return run.fill_mean()
