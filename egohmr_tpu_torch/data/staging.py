"""Resident staging of NumPy request batches on their way to the card
(`serving.py:Predictor`'s upload).

`to_torch` makes every request's NumPy leaves into fresh tensors: a
pageable copy, a copy into pinned memory, then the transfer on the stream
that runs the request. A `Staging` keeps instead, for one device and one
block of rows, per batch signature (the leaves' key paths, dtypes and
trailing shapes), a ring of resident host slots (pinned on CUDA) and, on
CUDA, two resident device slots:

  * `upload` writes the block's rows of a NumPy batch into the next host
    slot, one copy a leaf (torch's, which splits a large copy over the
    intra-op threads), a short batch padded by repeating its last row as
    `pad_batch` does; each leaf keeps the dtype and shape that
    `to_torch` gives it, at an aligned offset of the slot's one flat
    buffer;
  * on CUDA it queues the slot's transfer, one copy of the whole buffer,
    on its own copy stream into the next device slot, once the request
    that read that device slot last has copied it into its program's
    inputs (`Staged.consumed`), and records `Staged.ready` after it: the
    request's stream waits on `ready`, so one request's transfer runs
    while the request before it replays;
  * a host slot is written again only once its transfer is done; where the
    host has to wait for that, the wait is the span `serve.stage_wait`,
    counted in `waits`.

On the CPU the host slot is the staged block itself.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..utils.profiling import span

ALIGN = 256  # bytes: each leaf's offset in a slot is a multiple of this

Leaves = List[Tuple[Tuple[str, ...], np.ndarray]]


def numpy_leaves(batch, n: int) -> Optional[Leaves]:
    """The leaves of a batch of `n` rows with their key paths, in order; None
    unless the batch is a tree of dicts whose every leaf is a NumPy array of
    `n` rows and of a number dtype in the machine's byte order: what
    `to_torch` and `pad_batch` take, and the slots can hold."""
    leaves: Leaves = []

    def walk(tree: Dict, path: Tuple[str, ...]) -> bool:
        if not tree:
            return False
        for k, v in tree.items():
            if isinstance(v, dict):
                if not walk(v, path + (k,)):
                    return False
            elif (isinstance(v, np.ndarray) and v.ndim >= 1 and v.shape[0] == n
                  and v.dtype.isnative and v.dtype.kind in "biufc"):
                leaves.append((path + (k,), v))
            else:
                return False
        return True

    return leaves if isinstance(batch, dict) and walk(batch, ()) else None


def _copy(dst: torch.Tensor, src: np.ndarray) -> None:
    """`src` into `dst`, broadcast: by torch's copy where `torch.from_numpy`
    takes the array (writeable, no negative stride), else by NumPy's."""
    if src.flags.writeable and min(src.strides, default=0) >= 0:
        dst.copy_(torch.from_numpy(src))
    else:
        np.copyto(dst.numpy(), src)


def _tree(paths, tensors) -> Dict:
    """The nested dict of `tensors` at their key paths, keys in order."""
    out: Dict = {}
    for path, t in zip(paths, tensors):
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return out


class Staged(NamedTuple):
    """One block of a request in a slot: `batch`, the tree that `to_torch`
    and `pad_batch` give; on CUDA `ready`, recorded after its transfer, for
    the request's stream to wait on, and `consumed`, for that stream to
    record once the request's program has read the slot. Both None on the
    CPU."""

    batch: Dict
    ready: Optional[torch.cuda.Event]
    consumed: Optional[torch.cuda.Event]


class _Ring:
    """One signature's slots: host buffers and their leaf views, the staged
    blocks' leaves (the device slots' on CUDA, else the host slots'), and
    the events that order them."""

    def __init__(self, sig, rows: int, depth: int, device: torch.device,
                 stream: Optional[torch.cuda.Stream]):
        layout, off = [], 0
        for _, dtype, trail in sig:
            shape = (rows,) + tuple(trail)
            nbytes = int(np.prod(shape)) * dtype.itemsize
            layout.append((torch.from_numpy(np.empty(0, dtype)).dtype, shape, off, nbytes))
            off += -(-nbytes // ALIGN) * ALIGN
        self.paths = [path for path, _, _ in sig]

        def views(buf: torch.Tensor) -> List[torch.Tensor]:
            return [buf[o:o + nb].view(dt).view(shape) for dt, shape, o, nb in layout]

        cuda = stream is not None
        self.host = [torch.empty(off, dtype=torch.uint8, pin_memory=cuda) for _ in range(depth)]
        self.host_leaves = [views(h) for h in self.host]
        self.next_host = 0
        if cuda:
            self.dev = [torch.empty(off, dtype=torch.uint8, device=device) for _ in range(2)]
            for d in self.dev:
                d.record_stream(stream)  # freed only once the copies into it are done
            self.leaves = [views(d) for d in self.dev]
            self.copied = [torch.cuda.Event() for _ in self.host]
            self.consumed = [torch.cuda.Event() for _ in self.dev]
            self.next_dev = 0
        else:
            self.leaves = self.host_leaves


class Staging:
    """The staging of one block of `rows` rows of every request on `device`
    (see the module's docstring): a ring of `depth` host slots per batch
    signature, built when the signature is first seen. `rings` holds them;
    `waits` counts the uploads that waited for a host slot's transfer."""

    def __init__(self, device, rows: int, depth: int):
        self.device = torch.device(device)
        self.rows = int(rows)
        self.depth = int(depth)
        cuda = self.device.type == "cuda"
        self.stream = torch.cuda.Stream(self.device) if cuda else None
        self.rings: Dict[tuple, _Ring] = {}
        self.waits = 0

    def upload(self, leaves: Leaves, lo: int, n: int) -> Staged:
        """Rows `lo` to `lo + rows` of the batch of `n` rows whose leaves
        are `leaves` (`numpy_leaves`), padded by its last row, staged."""
        sig = tuple((path, x.dtype, x.shape[1:]) for path, x in leaves)
        ring = self.rings.get(sig)
        if ring is None:
            ring = self.rings[sig] = _Ring(sig, self.rows, self.depth, self.device,
                                           self.stream)
        h = ring.next_host
        ring.next_host = (h + 1) % self.depth
        if self.stream is not None and not ring.copied[h].query():
            with span("serve.stage_wait"):
                ring.copied[h].synchronize()
            self.waits += 1
        k = min(max(n - lo, 0), self.rows)  # the block's rows that the batch has
        for (_, x), dst in zip(leaves, ring.host_leaves[h]):
            _copy(dst[:k], x[lo:lo + k])
            if k < self.rows:
                _copy(dst[k:], x[n - 1:n])
        if self.stream is None:
            return Staged(_tree(ring.paths, ring.leaves[h]), None, None)
        d = ring.next_dev
        ring.next_dev = 1 - d
        with torch.cuda.stream(self.stream):
            self.stream.wait_event(ring.consumed[d])
            ring.dev[d].copy_(ring.host[h], non_blocking=True)
            ring.copied[h].record(self.stream)
        return Staged(_tree(ring.paths, ring.leaves[d]), ring.copied[h], ring.consumed[d])
