"""Tensors moved between the host and the card a request, both ways: the
port's ``ops.copies`` counter (``bench/program_steps.py``), counted where
``ops.to_device``/``ops.to_host`` cross to or from a CUDA device, so it
reads 0 on the CPU.  Traced runs; a count."""

from bench import program_steps


def read(record):
    return program_steps.per_request(record, "ops.copies")
