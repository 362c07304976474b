"""Multi-device placement: data-parallel reads x edge-sharded DB.

Port of ``rappas_tpu/parallel/mesh.py``.  A :class:`Mesh` is a ``(dp,
mp)`` grid of torch devices driven by one process (JAX's single
controller per host):

* **dp axis**: a read batch is cut into ``dp`` equal slices, one per mesh
  row -- reads are embarrassingly parallel;
* **mp axis**: the dense delta matrix ``D[S^k + 1, E]`` is cut into
  ``mp`` column (edge) shards; each device of a row sums its shard's
  ``[B / dp, E / mp]`` tile, the row's lead device (column 0) gathers
  the tiles and takes the top-K of the whole row.

The collectives that ``shard_map``/GSPMD insert in JAX are explicit
here and are copies, not kernels: the **all-gather** copies each tile to
the lead device after an event recorded on the source device's stream,
the **psum** of :mod:`rappas_tpu_torch.parallel.kmer_sharded` sums those
copies.  A mesh may repeat a device (``[cpu] * 8`` in the tests, ``[cuda:0]
* 4`` on one card): tables replicated over ``dp`` are put once per
distinct device, each distinct device has one stream, and a copy to the
same device is no copy at all.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from rappas_tpu_torch.convert import column_shards
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.place import kernels
from rappas_tpu_torch.place.engine import BatchResult, fetch_wire, stage


class Mesh:
    """A ``(dp, mp)`` grid of torch devices with the axis names of the
    JAX mesh; one stream per distinct CUDA device."""

    axis_names = ("dp", "mp")

    def __init__(self, devices: np.ndarray):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "mp": devices.shape[1]}
        self.distinct = list(dict.fromkeys(devices.ravel().tolist()))
        self._streams: dict = {}

    def put(self, array: np.ndarray, devices) -> dict:
        """``array`` on each distinct device of ``devices`` (a mesh column
        or row): ``{device: tensor}``."""
        t = torch.from_numpy(array)
        return {dev: t.to(dev) for dev in dict.fromkeys(devices)}

    def stream(self, dev: torch.device):
        """The stream of a CUDA device (made at first use, after the work
        queued so far on its current stream), None on the CPU."""
        if dev.type != "cuda":
            return None
        if dev not in self._streams:
            s = torch.cuda.Stream(dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            self._streams[dev] = s
        return self._streams[dev]

    def on(self, dev: torch.device):
        """Context: work queued inside runs on ``dev``'s stream."""
        s = self.stream(dev)
        return torch.cuda.stream(s) if s is not None \
            else contextlib.nullcontext()

    def gather(self, tiles: list, dst: torch.device) -> list:
        """All-gather: each tile as a tensor on ``dst``, copied after the
        work of its source device's stream (tiles already on ``dst`` are
        returned as they are).  Call inside ``self.on(dst)``."""
        out = []
        for t in tiles:
            if t.device == dst:
                out.append(t)
                continue
            src = self.stream(t.device)
            dst_s = self.stream(dst)
            if src is not None and dst_s is not None:
                ev = torch.cuda.Event()
                ev.record(src)
                dst_s.wait_event(ev)
                out.append(t.to(dst, non_blocking=True))
                t.record_stream(dst_s)
            else:
                if src is not None:
                    src.synchronize()
                out.append(t.to(dst))
        return out


def make_mesh(devices=None, dp: int | None = None, mp: int = 1) -> Mesh:
    """A ``(dp, mp)`` mesh over the given devices (all CUDA devices by
    default); a device may repeat."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if dp is None:
        dp = n // mp
    if dp * mp != n:
        raise ValueError(f"dp*mp = {dp}*{mp} != {n} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(dp, mp))


class PendingSlices:
    """Handle for a batch scored in ``dp`` slices: their handles, whose
    results are joined in slice order."""

    def __init__(self, parts: list):
        self._parts = parts

    def result(self) -> BatchResult:
        res = [p.result() for p in self._parts]
        return BatchResult(*(np.concatenate(x) for x in zip(*res)))


def dp_slices(mesh: Mesh, B: int):
    """``(d, slice)`` of each mesh row's reads; ``B`` must divide by dp
    (``rappas_tpu/parallel/engine.py:102-108``)."""
    dp = mesh.shape["dp"]
    if B % dp:
        raise ValueError(f"batch size {B} not divisible by dp={dp}"
                         " (use a batch size that is a multiple of dp)")
    Bl = B // dp
    return [(d, slice(d * Bl, (d + 1) * Bl)) for d in range(dp)]


def score_rows(mesh: Mesh, B: int, prepare, tile, finish, wire_k: int,
               wide: bool) -> PendingSlices:
    """One batch of ``B`` reads over the mesh, row by row: the host
    arrays of row ``d``'s slice (``prepare(slice)``, a dict) staged once
    on each distinct device of the row, ``tile(j, device, staged)`` on
    its ``mp`` devices, then on the row's lead device ``finish(tiles,
    staged)`` on the gathered tiles -> the slice's wire, fetched."""
    parts = []
    for d, sl in dp_slices(mesh, B):
        host = prepare(sl)
        staged, tiles = {}, []
        for j, dev in enumerate(mesh.devices[d]):
            with mesh.on(dev):
                if dev not in staged:
                    staged[dev] = stage(host, dev)
                tiles.append(tile(j, dev, staged[dev]))
        lead = mesh.devices[d, 0]
        with mesh.on(lead):
            wire = finish(mesh.gather(tiles, lead), staged[lead])
            parts.append(fetch_wire(wire, mesh.stream(lead), wire_k, wide))
    return PendingSlices(parts)


class ShardedPlacement:
    """K2 on each column shard of ``D`` over a (dp, mp) mesh, the tiles
    all-gathered on each row's lead device, then K3
    (``rappas_tpu/parallel/mesh.py:44-96``).

    ``D`` is cut over edges on the mp axis and replicated over dp; read
    batches are cut over dp."""

    def __init__(self, db: PhyloKmerDB, mesh: Mesh, keep_at_most: int = 7):
        self.db = db
        self.mesh = mesh
        self.k = db.k
        self.keep_at_most = keep_at_most
        self.thr = float(np.float32(db.thr_log10))
        shards = column_shards(db, "direct", mesh.shape["mp"])
        self.n_rows = shards[0].shape[0]
        self.D = [mesh.put(s, mesh.devices[:, j])
                  for j, s in enumerate(shards)]
        self.wire_k, self.wide, _ = kernels.wire_format(
            shards[0].shape[1] * len(shards), keep_at_most)

    def score(self, codes: np.ndarray, lengths: np.ndarray) -> BatchResult:
        """codes: int8[B, L] state codes (B divisible by dp)."""
        S = self.db.alphabet.n_states
        lengths = np.ascontiguousarray(lengths, np.int32)
        return score_rows(
            self.mesh, codes.shape[0],
            lambda sl: {"codes": codes[sl], "lengths": lengths[sl]},
            lambda j, dev, t: kernels.accumulate_codes(
                self.D[j][dev], t["codes"], self.k, S),
            lambda tiles, t: kernels.finalize_wire(
                torch.cat(tiles, dim=1), t["lengths"], self.thr, self.k,
                self.keep_at_most),
            self.wire_k, self.wide).result()
