"""Seconds from the start of the process to the first timed request: kernel
loading, the circuit build, the assignment where set-up fills it, the key
(read, or made on a checkout's first run), the QAP compile and the warm-up
request."""


def read(run):
    return run.setup_s
