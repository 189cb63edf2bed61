"""The program's peak of device memory over the window, in GiB: around each
question ``torch.cuda.max_memory_allocated()`` after a reset, less the
bytes of the answers the run keeps on the card for its check."""


def read(rec):
    return rec["peak_bytes"] / 2 ** 30 if rec["peak_bytes"] else None
