"""The store's logical IOs (``io_stats().n_iops``) in the window, a row
returned.  The port's own counter; traced runs; a count."""


def read(record):
    if record.iops is None or not record.rows:
        return None
    return record.iops / record.rows
