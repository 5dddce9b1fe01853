"""Share of a mini-block read's chunks whose word rows were staged in bulk,
%: the port's ``miniblock.chunks_staged`` counter (chunks whose streams the
device route copied straight from the read buffer into the kernels' word
rows) over ``miniblock.chunks`` (chunks fetched and decoded), through
``bench/program_steps.py``'s recorder.  None where no chunk was counted or
the port keeps no ``miniblock.chunks_staged`` counter: an untraced run, a
cell that reads no mini-block column, or a port without the bulk stager.
Traced runs; %."""

from bench import program_steps


def read(record):
    rec = program_steps.recorder(record)
    if rec is None:
        return None
    counts = rec.metrics.counter_values()
    chunks = counts.get("miniblock.chunks", 0)
    if "miniblock.chunks_staged" not in counts or chunks == 0:
        return None
    return counts["miniblock.chunks_staged"] / chunks * 100
