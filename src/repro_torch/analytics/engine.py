"""Partition-aware vertex-program engine (port of ``repro.analytics.engine``,
its ``simulated`` mode).

The K devices of a partition live on the leading axis of every array on one
real device (the card, or the CPU when asked). One iteration is:

  * the halo exchange: one index gathers what every device ships
    (``state[p, send_gather[p, q]]``), a transpose delivers it;
  * ``full = [state, recv, identity]`` per device;
  * ``x = message(full, degrees_full)``, elementwise over the whole vector
    (the same bits as ``message(full[cols], degrees_full[cols])``);
  * one launch of the gather/reduce kernel for all K devices' rows
    (:func:`repro_torch.kernels.ell_spmv.ops.ell_spmv_segments`);
  * ``apply``.

Every iteration stays on the device; the only copies to the host are the
initial state in and the final values out (:meth:`GraphEngine._gather_global`).
The engine's communication volume is exactly the paper's λ_CV·K·|V| when
counting true (unpadded) messages. The reference's ``shard_map`` mode (one
process per partition, the halo over a real all-to-all) is not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.analytics.localize import DeviceLocalized, LocalizedGraph
from repro_torch.analytics.programs import VertexProgram
from repro_torch.device import resolve_device
from repro_torch.kernels.ell_spmv.ops import ell_spmv_segments

__all__ = ["GraphEngine", "RunStats"]


@dataclasses.dataclass
class RunStats:
    iterations: int
    true_halo_messages_per_iter: int
    padded_halo_elements_per_iter: int
    bytes_per_iter_true: int
    bytes_per_iter_padded: int
    max_local_edges: int
    mean_local_edges: float


class GraphEngine:
    """Runs ``program`` on the layout ``lg`` on ``device`` (default
    ``"cuda"``; raises without a card unless ``device="cpu"``)."""

    def __init__(self, lg: LocalizedGraph, program: VertexProgram, ctx: dict | None = None,
                 device: str | torch.device | None = None):
        self.lg = lg
        self.program = program
        self.ctx = dict(ctx or {})
        self.ctx.setdefault("num_vertices", lg.num_vertices)
        self.device = resolve_device(device)

    def _step(self, dev: DeviceLocalized, state: torch.Tensor, devices: torch.Tensor,
              identity: torch.Tensor) -> torch.Tensor:
        """One iteration on ``state`` f32[k, v_max]."""
        k = self.lg.k
        send = state[devices, dev.send_gather]  # [k, k, h]: p ships send[p, q] to q
        recv = send.transpose(0, 1).reshape(k, -1)  # all-to-all: recv[p, q*h + j]
        full = torch.cat([state, recv, identity], dim=1)
        msgs = self.program.message(full, dev.degrees_full)
        agg = ell_spmv_segments(msgs, dev.row_ptr, dev.cols, self.program.reduce_kind)
        return self.program.apply(state, agg, self.ctx)

    def run_simulated(self, iters: int) -> np.ndarray:
        """float32[|V|]: every vertex's state after ``iters`` iterations."""
        dev = self.lg.to(self.device)
        state = torch.from_numpy(self.program.init_state(self.lg, self.ctx)).to(self.device)
        devices = torch.arange(self.lg.k, device=self.device)[:, None, None]
        identity = torch.full((self.lg.k, 1), self.program.identity, dtype=torch.float32,
                              device=self.device)
        for _ in range(iters):
            state = self._step(dev, state, devices, identity)
        return self._gather_global(state.cpu().numpy())

    # -------------------------------------------------------------- helpers
    def _gather_global(self, state_kv: np.ndarray) -> np.ndarray:
        out = np.zeros(self.lg.num_vertices, dtype=state_kv.dtype)
        for p in range(self.lg.k):
            c = int(self.lg.local_count[p])
            out[self.lg.local_to_global[p, :c]] = state_kv[p, :c]
        return out

    def stats(self, iters: int, bytes_per_elem: int = 4) -> RunStats:
        lg = self.lg
        true_m = lg.true_halo_messages()
        padded = lg.padded_halo_elements_per_iter()
        edges_per_dev = (lg.rows != lg.v_max).sum(axis=1)
        return RunStats(
            iterations=iters,
            true_halo_messages_per_iter=true_m,
            padded_halo_elements_per_iter=padded,
            bytes_per_iter_true=true_m * bytes_per_elem,
            bytes_per_iter_padded=padded * bytes_per_elem,
            max_local_edges=int(edges_per_dev.max()),
            mean_local_edges=float(edges_per_dev.mean()),
        )
