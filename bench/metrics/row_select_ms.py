"""Host self time of the mini-block take's row selection, a request: the
port's ``miniblock.select`` step, which picks the requested rows' entries
out of every decoded chunk (row ids, selection, fan-out to request order),
less the steps nested in it (``bench/program_steps.py``).  Traced runs; ms."""

from bench import program_steps


def read(record):
    return program_steps.self_ms(record, "miniblock.select")
