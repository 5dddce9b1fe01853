"""Share of a mini-block take's rows that the device selected, %: the
port's ``miniblock.rows_on_card`` counter (unique rows whose entries the
``miniblock_take`` kernel decoded alone) over it and
``miniblock.rows_on_host`` (unique rows picked on the host out of whole
decoded chunks), through ``bench/program_steps.py``'s recorder.  None where
neither counted: an untraced run, a cell that reads no mini-block column,
or a port without those counters.  Traced runs; %."""

from bench import program_steps


def read(record):
    rec = program_steps.recorder(record)
    if rec is None:
        return None
    counts = rec.metrics.counter_values()
    card = counts.get("miniblock.rows_on_card", 0)
    host = counts.get("miniblock.rows_on_host", 0)
    if card + host == 0:
        return None
    return card / (card + host) * 100
