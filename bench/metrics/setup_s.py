"""Seconds from the process's start to the first measured query: imports,
the kernel libraries (built on a checkout's first run), the relations
drawn and laid out on the device, and the warm step."""


def read(record):
    return record["setup_s"]
