"""Set-up: from the start of the process to the start of the window (import,
CUDA start, kernel libraries loaded or built, data made and written, reader
opened, warm-up requests).  Host clock; seconds."""


def read(record):
    return record.setup_s
