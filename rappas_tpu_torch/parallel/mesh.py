"""Multi-device placement: data-parallel reads x edge-sharded DB.

Port of ``rappas_tpu/parallel/mesh.py``.  A :class:`Mesh` is a ``(dp,
mp)`` grid of torch devices:

* **dp axis**: a read batch is cut into ``dp`` equal slices, one per mesh
  row -- reads are embarrassingly parallel;
* **mp axis**: the dense delta matrix ``D[S^k + 1, E]`` is cut into
  ``mp`` column (edge) shards; each device of a row sums its shard's
  ``[B / dp, E / mp]`` tile, the row's tiles are all-gathered and the
  top-K taken over the whole row.

By default one process drives every device of the mesh (JAX's single
controller per host).  A mesh made with ``ranks`` (the ``torch.distributed``
rank that owns each device) spans processes, as a JAX mesh over the
devices of several ``jax.distributed`` processes does: each process puts
tables only on its own devices, scores only the mesh rows it holds a
device of, and a row whose devices belong to several processes
all-gathers (:meth:`Mesh.gather`) or sums (:meth:`Mesh.psum`) over a
process group of that row; every process of the row then holds the full
row, as under JAX's ``out_specs``.

Inside one process the collectives that ``shard_map``/GSPMD insert in JAX
are copies, not kernels: each tile is copied to the finishing device
after an event recorded on the source device's stream.  A mesh may repeat
a device (``[cpu] * 8`` in the tests, ``[cuda:0] * 4`` on one card):
tables replicated over ``dp`` are put once per distinct device, each
distinct device has one stream, and a copy to the same device is no copy
at all.
"""

from __future__ import annotations

import contextlib
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from rappas_tpu_torch.convert import column_shards
from rappas_tpu_torch.db import PhyloKmerDB
from rappas_tpu_torch.place import kernels
from rappas_tpu_torch.place.engine import BatchResult, fetch_wire, stage

#: how long a mesh row's process group waits for a rank that does not
#: arrive before the collective fails (a rank that died fails the others)
JOIN_TIMEOUT = timedelta(seconds=60)


class Mesh:
    """A ``(dp, mp)`` grid of torch devices with the axis names of the
    JAX mesh; one stream per distinct CUDA device.

    ``ranks`` (an int array of the devices' shape, default: this process
    owns every device) names the ``torch.distributed`` rank that owns each
    device; the group must be joined first.  Every rank of the group makes
    the same mesh, in the same order as its other meshes: the row groups
    are made here, one ``new_group`` per row that spans ranks, by every
    rank, in row order.  A row group runs NCCL where each of its ranks
    names CUDA devices no other rank of the row names, gloo otherwise
    (CPU meshes, or ranks that share one card)."""

    axis_names = ("dp", "mp")

    def __init__(self, devices: np.ndarray, ranks=None):
        self.devices = devices
        self.shape = {"dp": devices.shape[0], "mp": devices.shape[1]}
        self._streams: dict = {}
        self._groups: dict = {}
        if ranks is None:
            self.ranks = None
            self.owned = np.ones(devices.shape, bool)
        else:
            self.ranks = self._check_ranks(ranks)
            self.owned = self.ranks == dist.get_rank()
            self._make_groups()
        self.distinct = list(dict.fromkeys(
            devices[self.owned].ravel().tolist()))

    def _check_ranks(self, ranks) -> np.ndarray:
        if not dist.is_initialized():
            raise ValueError("a mesh with ranks needs a joined "
                             "torch.distributed group")
        ranks = np.asarray(ranks, np.int64)
        if ranks.size != self.devices.size:
            raise ValueError(f"ranks {ranks.shape} for a mesh of "
                             f"{self.devices.shape} devices")
        ranks = ranks.reshape(self.devices.shape)
        world = dist.get_world_size()
        if ranks.min() < 0 or ranks.max() >= world:
            raise ValueError(f"ranks {sorted(set(ranks.ravel().tolist()))} "
                             f"outside the group of {world} ranks")
        for d, row in enumerate(ranks):
            counts = np.unique(row, return_counts=True)[1]
            if len(set(counts.tolist())) > 1:
                raise ValueError(f"mesh row {d}: ranks {row.tolist()} own "
                                 "unequal numbers of its devices")
        return ranks

    def _make_groups(self) -> None:
        me = dist.get_rank()
        for d, row in enumerate(self.ranks):
            members = sorted(set(row.tolist()))
            if len(members) == 1:
                continue
            devs = self.devices[d]
            owners: dict = {}
            for dev, r in zip(devs, row):
                owners.setdefault(dev, set()).add(int(r))
            own_cards = all(dev.type == "cuda" for dev in devs) and \
                all(len(o) == 1 for o in owners.values())
            backend = "nccl" if own_cards else "gloo"
            group = dist.new_group(members, timeout=JOIN_TIMEOUT,
                                   backend=backend)
            if me in members:
                cols = [[j for j in range(len(row)) if row[j] == r]
                        for r in members]
                self._groups[d] = (group, backend, cols)

    # -------------------------------------------------------------- #
    def column(self, j: int) -> list:
        """The devices of mesh column ``j`` that this process owns."""
        return [dev for dev, own in zip(self.devices[:, j], self.owned[:, j])
                if own]

    def row_columns(self, d: int) -> list:
        """``(j, device)`` of the devices of mesh row ``d`` that this
        process owns, in column order (empty for a row it holds none of)."""
        return [(j, self.devices[d, j]) for j in range(self.shape["mp"])
                if self.owned[d, j]]

    def local_rows(self) -> list:
        """The mesh rows this process holds a device of: the dp slices
        whose results it returns, in order."""
        return [d for d in range(self.shape["dp"]) if self.owned[d].any()]

    def lead(self, d: int) -> torch.device:
        """The device that finishes row ``d`` here: this process's first
        device in it."""
        return self.row_columns(d)[0][1]

    def put(self, array: np.ndarray, devices) -> dict:
        """``array`` on each distinct device of ``devices`` (a mesh
        :meth:`column`, or ``distinct``): ``{device: tensor}``."""
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

    def _local(self, tiles: list, dst: torch.device) -> list:
        """Each tile as a tensor on ``dst``, copied after the work of its
        source device's stream (tiles already on ``dst`` are returned as
        they are)."""
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

    def gather(self, tiles: list, d: int) -> list:
        """All-gather of row ``d``: this process's tiles of the row (in
        :meth:`row_columns` order, one shape) -> all ``mp`` tiles of the
        row in column order, on :meth:`lead`.  Call inside
        ``self.on(self.lead(d))``; across processes it returns when the
        collective has (synchronous)."""
        local = self._local(tiles, self.lead(d))
        if d not in self._groups:
            return local
        group, backend, cols = self._groups[d]
        x = torch.stack(local)
        staged = _to_host(x, backend)
        parts = [torch.empty(staged.shape, dtype=staged.dtype,
                             device=staged.device,
                             pin_memory=staged.is_pinned()) for _ in cols]
        dist.all_gather(parts, staged, group=group)
        out = [None] * self.shape["mp"]
        for js, part in zip(cols, parts):
            part = part.to(x.device, non_blocking=True)
            for j, t in zip(js, part):
                out[j] = t
        return out

    def psum(self, tiles: list, d: int) -> torch.Tensor:
        """Sum over row ``d``'s tiles (JAX's ``psum`` over mp): this
        process's tiles summed in column order on :meth:`lead`, then an
        all-reduce over the row's group where the row spans processes.
        Call inside ``self.on(self.lead(d))``."""
        local = self._local(tiles, self.lead(d))
        acc = local[0]
        for x in local[1:]:
            acc = acc + x
        if d not in self._groups:
            return acc
        group, backend, _ = self._groups[d]
        staged = _to_host(acc, backend)
        dist.all_reduce(staged, group=group)
        return staged.to(acc.device, non_blocking=True)


def _to_host(x: torch.Tensor, backend: str) -> torch.Tensor:
    """The tensor a collective of ``backend`` takes for ``x``: gloo has no
    collectives on CUDA tensors, so a CUDA tensor goes through a pinned
    host copy (after the work of the current stream); otherwise ``x``."""
    if backend != "gloo" or x.device.type != "cuda":
        return x
    host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    host.copy_(x)
    return host


def make_mesh(devices=None, dp: int | None = None, mp: int = 1,
              ranks=None) -> Mesh:
    """A ``(dp, mp)`` mesh over the given devices (all CUDA devices by
    default); a device may repeat.  ``ranks`` (``(dp, mp)`` ints, the
    owner of each device) makes a mesh that spans the processes of the
    joined ``torch.distributed`` group (:class:`Mesh`); it must name only
    ranks of that group."""
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
    return Mesh(arr.reshape(dp, mp), ranks)


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
    """One batch of ``B`` reads over the mesh, row by row (the rows this
    process holds a device of): the host arrays of row ``d``'s slice
    (``prepare(slice)``, a dict) staged once on each distinct device of
    the row, ``tile(j, device, staged)`` on its devices, then on the
    row's :meth:`Mesh.lead` ``finish(d, tiles, staged)``, which gathers
    or sums the row's tiles -> the slice's wire, fetched."""
    parts = []
    for d, sl in dp_slices(mesh, B):
        cols = mesh.row_columns(d)
        if not cols:
            continue
        host = prepare(sl)
        staged, tiles = {}, []
        for j, dev in cols:
            with mesh.on(dev):
                if dev not in staged:
                    staged[dev] = stage(host, dev)
                tiles.append(tile(j, dev, staged[dev]))
        lead = mesh.lead(d)
        with mesh.on(lead):
            wire = finish(d, tiles, staged[lead])
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
        self.D = [mesh.put(s, mesh.column(j))
                  for j, s in enumerate(shards)]
        self.wire_k, self.wide, _ = kernels.wire_format(
            shards[0].shape[1] * len(shards), keep_at_most)

    def score(self, codes: np.ndarray, lengths: np.ndarray) -> BatchResult:
        """codes: int8[B, L] state codes (B divisible by dp) -> the
        results of the mesh's :meth:`~Mesh.local_rows`."""
        S = self.db.alphabet.n_states
        lengths = np.ascontiguousarray(lengths, np.int32)
        return score_rows(
            self.mesh, codes.shape[0],
            lambda sl: {"codes": codes[sl], "lengths": lengths[sl]},
            lambda j, dev, t: kernels.accumulate_codes(
                self.D[j][dev], t["codes"], self.k, S),
            lambda d, tiles, t: kernels.finalize_wire(
                torch.cat(self.mesh.gather(tiles, d), dim=1), t["lengths"],
                self.thr, self.k, self.keep_at_most),
            self.wire_k, self.wide).result()
