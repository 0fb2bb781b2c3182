"""Turn (graph, partition) into per-device padded local structures (port of
``repro.analytics.localize``; the arrays equal the reference's).

Index space on device p (all devices identical shapes):

    [0, Vmax)                  local vertex states
    [Vmax, Vmax + K*H)         ghost states: slot Vmax + q*H + j holds the
                               j-th vertex imported from partition q
    Vmax + K*H                 identity slot (padding edges point here)

``send_gather[q]`` on device p lists the local indices p must ship to q each
iteration; after the all-to-all, ``recv[q]`` holds what q shipped to p, laid
out exactly as p's ghost table expects.

``rows[p]`` is non-decreasing (the edges of device p in CSR order, pads
``v_max`` last), so :meth:`LocalizedGraph.row_ptr` gives each device's CSR
row pointer, and :meth:`LocalizedGraph.to` places what the engine reads on a
device. ``localize`` runs on the host in numpy.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.graph.csr import CSRGraph

__all__ = ["DeviceLocalized", "LocalizedGraph", "localize"]


@dataclasses.dataclass(frozen=True)
class DeviceLocalized:
    """What the engine reads each iteration, on one device."""

    cols: torch.Tensor  # int32[k, e_max]
    row_ptr: torch.Tensor  # int64[k, v_max + 1]
    degrees_full: torch.Tensor  # float32[k, state_len]
    send_gather: torch.Tensor  # int64[k, k, h_max] (a sharded rank's: [k, h_max])


@dataclasses.dataclass
class LocalizedGraph:
    k: int
    v_max: int  # max local vertices per device
    h_max: int  # max ghosts imported from any single partition
    e_max: int  # max local edge slots per device
    num_vertices: int
    num_edges: int
    # --- per-device arrays, leading axis = device/partition
    local_to_global: np.ndarray  # int32[k, v_max], -1 pad
    local_count: np.ndarray  # int32[k]
    rows: np.ndarray  # int32[k, e_max] local row of each edge slot (v_max pad)
    cols: np.ndarray  # int32[k, e_max] combined-index col (identity pad)
    send_gather: np.ndarray  # int32[k, k, h_max] local idx to send (0 pad)
    send_count: np.ndarray  # int32[k, k] true ghosts q imports from p
    degrees_full: np.ndarray  # float32[k, v_max + k*h_max + 1] degree table
    local_degrees: np.ndarray  # float32[k, v_max]
    part: np.ndarray  # int32[|V|] original assignment
    global_to_local: np.ndarray  # int32[|V|] local index of each vertex
    _on_device: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def state_len(self) -> int:
        return self.v_max + self.k * self.h_max + 1

    @property
    def identity_slot(self) -> int:
        return self.state_len - 1

    # ---- communication accounting -----------------------------------------
    def true_halo_messages(self) -> int:
        """Σ_u D(u): exactly K·|V|·λ_CV (paper Eq. 4)."""
        return int(self.send_count.sum())

    def padded_halo_elements_per_iter(self) -> int:
        """Elements actually moved by the padded all-to-all per iteration."""
        return int(self.k * self.k * self.h_max)

    def max_local_edges(self) -> int:
        return int((self.rows != self.v_max).sum(axis=1).max())

    # ---- device layout -----------------------------------------------------
    def row_ptr(self) -> np.ndarray:
        """int64[k, v_max+1]: device ``p``'s row ``r`` holds edge slots
        ``[row_ptr[p, r], row_ptr[p, r+1])``; pad slots (``rows == v_max``)
        lie past ``row_ptr[p, v_max]``. Raises unless every ``rows[p]`` is
        non-decreasing with values in ``[0, v_max]``."""
        rows = self.rows
        if rows.size and (
            rows.min() < 0 or rows.max() > self.v_max or (np.diff(rows, axis=1) < 0).any()
        ):
            raise ValueError("rows must be non-decreasing per device, in [0, v_max]")
        bounds = np.arange(self.v_max + 1)
        return np.stack(
            [np.searchsorted(rows[p], bounds, side="left") for p in range(self.k)]
        ).astype(np.int64).reshape(self.k, self.v_max + 1)

    def to(self, device: torch.device) -> DeviceLocalized:
        """The engine's arrays on ``device``, built on first use and kept
        for the layout's lifetime (on the CPU ``cols`` and ``degrees_full``
        share memory with the numpy arrays)."""
        device = resolve_device(device)  # "cuda" and "cuda:0" share one copy
        key = str(device)
        dev = self._on_device.get(key)
        if dev is None:
            dev = DeviceLocalized(
                cols=torch.from_numpy(np.ascontiguousarray(self.cols, np.int32)).to(device),
                row_ptr=torch.from_numpy(self.row_ptr()).to(device),
                degrees_full=torch.from_numpy(
                    np.ascontiguousarray(self.degrees_full, np.float32)).to(device),
                send_gather=torch.from_numpy(self.send_gather.astype(np.int64)).to(device),
            )
            self._on_device[key] = dev
        return dev


def localize(graph: CSRGraph, part: np.ndarray, k: int) -> LocalizedGraph:
    part = np.asarray(part, dtype=np.int32)
    n = graph.num_vertices
    global_to_local = np.zeros(n, dtype=np.int32)
    locals_of: list[np.ndarray] = []
    for p in range(k):
        ids = np.flatnonzero(part == p).astype(np.int32)
        locals_of.append(ids)
        global_to_local[ids] = np.arange(ids.shape[0], dtype=np.int32)
    v_max = max(int(ids.shape[0]) for ids in locals_of) if k else 0
    v_max = max(v_max, 1)

    dst_all = graph.indices.astype(np.int64)
    psrc = np.repeat(part, graph.degrees)
    lsrc = np.repeat(global_to_local, graph.degrees)
    pdst = part[dst_all]

    # the edges each device owns, in CSR order: (local row of the source,
    # destination, destination's partition), selected once per device
    owned = []
    for p in range(k):
        mask_p = psrc == p
        owned.append((lsrc[mask_p], dst_all[mask_p], pdst[mask_p]))
    del psrc, lsrc, pdst, dst_all

    # ghosts[p][q] = sorted unique vertices of partition q needed by p
    ghosts: list[list[np.ndarray]] = [[None] * k for _ in range(k)]
    h_max = 1
    for p in range(k):
        _, e_dst, e_pdst = owned[p]
        for q in range(k):
            if q == p:
                ghosts[p][q] = np.empty(0, dtype=np.int64)
                continue
            need = np.unique(e_dst[e_pdst == q])
            ghosts[p][q] = need
            h_max = max(h_max, need.shape[0])

    e_counts = [e[0].shape[0] for e in owned]
    e_max = max(max(e_counts) if k else 0, 1)

    local_to_global = np.full((k, v_max), -1, dtype=np.int32)
    local_count = np.zeros(k, dtype=np.int32)
    rows = np.full((k, e_max), v_max, dtype=np.int32)
    state_len = v_max + k * h_max + 1
    cols = np.full((k, e_max), state_len - 1, dtype=np.int32)
    send_gather = np.zeros((k, k, h_max), dtype=np.int32)
    send_count = np.zeros((k, k), dtype=np.int32)
    degrees_full = np.zeros((k, state_len), dtype=np.float32)
    local_degrees = np.zeros((k, v_max), dtype=np.float32)
    deg = graph.degrees.astype(np.float32)

    for p in range(k):
        ids = locals_of[p]
        local_to_global[p, : ids.shape[0]] = ids
        local_count[p] = ids.shape[0]
        local_degrees[p, : ids.shape[0]] = deg[ids]
        degrees_full[p, : ids.shape[0]] = deg[ids]
        e_row, e_dst, e_pdst = owned[p]
        rows[p, : e_row.shape[0]] = e_row
        col_vals = np.empty(e_row.shape[0], dtype=np.int32)
        intern = e_pdst == p
        col_vals[intern] = global_to_local[e_dst[intern]]
        for q in range(k):
            if q == p:
                continue
            sel = e_pdst == q
            if not sel.any():
                continue
            g = ghosts[p][q]
            slot_base = v_max + q * h_max
            # position of each dst within the sorted unique ghost list
            pos = np.searchsorted(g, e_dst[sel])
            col_vals[sel] = (slot_base + pos).astype(np.int32)
            degrees_full[p, slot_base : slot_base + g.shape[0]] = deg[g]
        cols[p, : e_row.shape[0]] = col_vals
        # what every OTHER device must send to p -> recorded on the sender q
        for q in range(k):
            g = ghosts[p][q]
            if q == p or g.shape[0] == 0:
                continue
            send_gather[q, p, : g.shape[0]] = global_to_local[g]
            send_count[q, p] = g.shape[0]

    return LocalizedGraph(
        k=k,
        v_max=v_max,
        h_max=h_max,
        e_max=e_max,
        num_vertices=n,
        num_edges=graph.num_edges,
        local_to_global=local_to_global,
        local_count=local_count,
        rows=rows,
        cols=cols,
        send_gather=send_gather,
        send_count=send_count,
        degrees_full=degrees_full,
        local_degrees=local_degrees,
        part=part,
        global_to_local=global_to_local,
    )
