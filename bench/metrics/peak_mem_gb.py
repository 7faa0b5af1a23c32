"""The device memory the program held at most during the window
(``torch.cuda.max_memory_allocated`` after a reset at its start), in GB."""


def read(record):
    if record["device"]["platform"] != "gpu":
        return None
    return record["peak_mem_bytes"] / 1e9
