"""Rows returned by all the window's scans over the window's time (its start
to the end of its last scan; no scan is cut or dropped).  Host clock;
rows/s."""


def read(record):
    if record.mix != "scan" or not record.rows:
        return None
    return record.rows / record.window_s
