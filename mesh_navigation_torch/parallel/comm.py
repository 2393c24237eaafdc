"""The transport rule of the port's multi-process solves, stated once.

- Under NCCL every collective and every send runs on the rank's card; a
  tensor off the card is refused.
- Under gloo, which runs send / recv and all_gather on host tensors only,
  every CUDA tensor is staged through a pinned host buffer, for every
  collective (all-reduces too, so that one rule holds); a CPU tensor goes
  as it is.
- The backend is the caller's (distributed.initialize): nothing here
  switches it.

Without a process group (one process), or over an axis of one rank, every
operation is the identity. `SENT_BYTES` counts what this process put on
the wire (the payload of its sends and of its all-reduce and all-gather
inputs), by kind, as ops/kernels.LAUNCHES counts launches.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

SENT_BYTES: dict[str, int] = {"p2p": 0, "all_reduce": 0, "all_gather": 0}


def reset_sent_bytes() -> None:
    for k in SENT_BYTES:
        SENT_BYTES[k] = 0


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Comm:
    """One rank's transport for one solve on `device`; holds the pinned
    buffers it stages through, reused from call to call."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.backend = dist.get_backend() if dist.is_initialized() else None
        if self.backend == "nccl" and self.device.type != "cuda":
            raise ValueError(f"NCCL moves tensors on the card only, not on {self.device}")
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._bufs: dict = {}

    def _buf(self, key, like: torch.Tensor) -> torch.Tensor:
        buf = self._bufs.get(key)
        if buf is None or buf.shape != like.shape or buf.dtype != like.dtype:
            buf = torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
            self._bufs[key] = buf
        return buf

    def _out(self, key, t: torch.Tensor) -> torch.Tensor:
        """What goes on the wire for `t`: a pinned copy when staged."""
        if not self.staged:
            return t
        buf = self._buf(key, t)
        buf.copy_(t)
        return buf

    def all_reduce_(self, t: torch.Tensor, op, group=None, n: int = 2) -> torch.Tensor:
        """In-place all-reduce of `t` over `group` (None: every rank), an
        axis of `n` ranks."""
        if self.backend is None or n == 1:
            return t
        SENT_BYTES["all_reduce"] += _nbytes(t)
        wire = self._out(("reduce", t.shape, t.dtype), t)
        dist.all_reduce(wire, op=op, group=group)
        if wire is not t:
            t.copy_(wire)
        return t

    def all_gather(self, t: torch.Tensor, group, n: int) -> list[torch.Tensor]:
        """Every rank's `t` (contiguous, one shape on every rank) over
        `group`, an axis of `n` ranks, in the group's rank order, on this
        rank's device."""
        if self.backend is None or n == 1:
            return [t]
        SENT_BYTES["all_gather"] += _nbytes(t)
        wire = self._out(("gather", t.shape, t.dtype), t)
        outs = [self._buf(("gathered", i), wire) if self.staged else torch.empty_like(t)
                for i in range(n)]
        dist.all_gather(outs, wire, group=group)
        return [o.to(self.device) for o in outs] if self.staged else outs

    def exchange(self, sends: list, recvs: list) -> None:
        """One batch of point-to-point transfers: `sends` and `recvs` are
        (contiguous tensor, global peer rank) pairs, at most one each way
        per peer; each received tensor is filled in place. A send is read
        before any receive of the batch lands only where it is staged, so a
        caller keeps the two apart."""
        if not sends and not recvs:
            return
        ops, fills = [], []
        for i, (t, peer) in enumerate(sends):
            SENT_BYTES["p2p"] += _nbytes(t)
            ops.append(dist.P2POp(dist.isend, self._out(("send", i), t), peer))
        for i, (t, peer) in enumerate(recvs):
            wire = self._buf(("recv", i), t) if self.staged else t
            ops.append(dist.P2POp(dist.irecv, wire, peer))
            fills.append((t, wire))
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        for t, wire in fills:
            if wire is not t:
                t.copy_(wire)
