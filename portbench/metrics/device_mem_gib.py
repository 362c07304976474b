"""device_mem_gib: ``torch.cuda.max_memory_allocated`` over set-up and
window, the largest over the cards the cell uses, in GiB."""


def read(run: dict):
    b = run.get("memory_peak_bytes")
    return b / 2 ** 30 if b else None
