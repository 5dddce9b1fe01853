"""Host self time of the mini-block chunks' word packing and unpacking, a
request: the port's ``miniblock.pack`` step (each chunk's streams packed
into 32-bit words and stacked for the decode kernel) plus its
``miniblock.unpack`` step (the kernel's output sliced back into one array a
chunk), each less the steps nested in it (``bench/program_steps.py``).
Traced runs; ms."""

from bench import program_steps


def read(record):
    return program_steps.self_ms(record, "miniblock.pack", "miniblock.unpack")
