"""Host self time of each file's unshred on a scan, a request: the port's
``file.assemble`` step, which turns a fragment's decoded leaves into its
column, less the steps nested in it (``bench/program_steps.py``).  Traced
runs; ms."""

from bench import program_steps


def read(record):
    return program_steps.self_ms(record, "file.assemble")
