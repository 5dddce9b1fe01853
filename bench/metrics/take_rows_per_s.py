"""Rows returned by all the window's takes over the window's time (its start
to the end of its last take).  Host clock; rows/s."""


def read(record):
    if record.mix != "take" or not record.rows:
        return None
    return record.rows / record.window_s
