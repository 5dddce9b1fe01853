"""Share of the spans a take gathered through a per-byte index, %: the
port's ``store.gather_spans.indexed`` counter over it and
``store.gather_spans.strided`` and ``.sliced`` (the three routes of
``Disk.read_gather``, tallied by ``ReadBatch.read_many``), through
``bench/program_steps.py``'s recorder.  None where no span was counted: an
untraced run, or a port without those counters.  Traced runs; %."""

from bench import program_steps

ROUTES = ("strided", "sliced", "indexed")


def read(record):
    rec = program_steps.recorder(record)
    if rec is None:
        return None
    counts = rec.metrics.counter_values()
    spans = {r: counts.get(f"store.gather_spans.{r}", 0) for r in ROUTES}
    total = sum(spans.values())
    if total == 0:
        return None
    return spans["indexed"] / total * 100
