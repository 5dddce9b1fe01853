"""Mini-block chunks read and decoded a request: the port's
``miniblock.chunks`` counter, counted where the chunks are decoded
(``bench/program_steps.py``).  Traced runs; a count."""

from bench import program_steps


def read(record):
    return program_steps.per_request(record, "miniblock.chunks")
