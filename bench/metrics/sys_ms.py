"""System time of the calling thread inside ``DatasetReader.take``/``.scan``,
a request: the port's ``dataset.sys_us`` counter, the thread's
``getrusage`` ``ru_stime`` across each call (``bench/program_steps.py``).
It holds the kernel's work for the host memory a request maps, touches and
frees.  Traced runs; ms."""

from bench import program_steps


def read(record):
    return program_steps.per_request(record, "dataset.sys_us", scale=1e-3)
