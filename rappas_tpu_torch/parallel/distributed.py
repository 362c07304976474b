"""Multi-host placement: process setup, input sharding, output merge.

Port of ``rappas_tpu/parallel/distributed.py``.  Reads are embarrassingly
parallel, so every host joins one ``torch.distributed`` process group
(gloo, over TCP: only a barrier crosses hosts), places its round-robin
shard of the query stream against its own DB copy on its local mesh, and
writes a per-host jplace part; rank 0 merges the parts.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Iterable, Iterator


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> tuple[int, int]:
    """Join the process group at ``coordinator`` (``HOST:PORT``; rank 0
    listens there) as ``process_id`` of ``num_processes``; without a
    coordinator, a no-op.  Returns (process_id, num_processes)."""
    import torch.distributed as dist

    if coordinator is None:
        return 0, 1
    dist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)
    return dist.get_rank(), dist.get_world_size()


def shard_reads(reads: Iterable[tuple[str, str]], process_id: int,
                num_processes: int) -> Iterator[tuple[str, str]]:
    """Round-robin shard of a read stream for this host.

    Note: duplicate-read detection (the jplace ``nm`` grouping) then
    applies per shard; duplicates split across hosts appear as separate
    placements with identical ``p`` rows -- semantically equivalent
    jplace, documented deviation from the strictly-serial reference.
    """
    for i, item in enumerate(reads):
        if i % num_processes == process_id:
            yield item


def _iter_placements(text: str):
    """Yield placement objects from a jplace document incrementally.

    Locates the ``"placements"`` array and ``raw_decode``s one element
    at a time, so only the source *text* (not a parsed object tree) is
    resident (the single-host writer is hand-rolled for the same reason,
    ``rappas_tpu_torch/place/jplace.py``).
    """
    dec = json.JSONDecoder()
    i = text.index('"placements"')
    i = text.index("[", i) + 1
    n = len(text)
    while True:
        while i < n and text[i] in " \t\r\n,":
            i += 1
        if i >= n or text[i] == "]":
            return
        obj, i = dec.raw_decode(text, i)
        yield obj


def _decode_key(text: str, key: str):
    """Decode one top-level value from a jplace document without parsing
    the (potentially huge) placements array."""
    dec = json.JSONDecoder()
    i = text.index(f'"{key}"')
    i = text.index(":", i) + 1
    while text[i] in " \t\r\n":
        i += 1
    obj, _ = dec.raw_decode(text, i)
    return obj


def merge_jplace(parts: list[str | Path], out: str | Path) -> None:
    """Merge per-host jplace files (same tree/fields) into one.

    Streams: holds one part's text at a time and writes placements as
    they decode (one per line, like the single-host writer), never
    materialising the merged placement list.
    """
    parts = [Path(p) for p in parts]
    if not parts:
        raise ValueError("no jplace parts to merge")
    head_text = parts[0].read_text()
    head = {k: _decode_key(head_text, k) for k in ("tree", "fields")}
    try:
        head["metadata"] = _decode_key(head_text, "metadata")
    except ValueError:
        head["metadata"] = {}
    del head_text
    with open(out, "w") as f:
        f.write('{"tree":')
        f.write(json.dumps(head["tree"]))
        f.write(',\n"placements":[')
        first = True
        for p in parts:
            text = p.read_text()
            if _decode_key(text, "tree") != head["tree"] or \
                    _decode_key(text, "fields") != head["fields"]:
                raise ValueError(f"jplace {p} is not mergeable "
                                 "(tree/fields differ)")
            for obj in _iter_placements(text):
                f.write("\n" if first else ",\n")
                first = False
                f.write(json.dumps(obj, separators=(",", ":")))
        f.write('\n],\n"version":3,\n"metadata":')
        f.write(json.dumps(head.get("metadata", {})))
        f.write(',\n"fields":')
        f.write(json.dumps(head["fields"]))
        f.write("}\n")
