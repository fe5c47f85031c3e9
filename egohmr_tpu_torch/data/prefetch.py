"""Host-to-device batch prefetching (port of egohmr_tpu/data/prefetch.py).

A background thread reads the next batches from a host iterator and copies
them to the device while the current step runs: on a CUDA device through
pinned memory, `non_blocking`, on a side stream, and the consumer's stream
waits for each batch's copy before using it. An error in the producer is
raised on the consumer's side; closing the iterator ends the thread."""
from __future__ import annotations

import queue
import threading
from typing import Any, Iterator

import torch

from .egobody import to_device_batch


def _record_stream(tree, stream) -> None:
    if isinstance(tree, dict):
        for v in tree.values():
            _record_stream(v, stream)
    elif isinstance(tree, torch.Tensor):
        tree.record_stream(stream)


def prefetch_to_device(iterator: Iterator[Any], *, size: int = 2,
                       device="cpu") -> Iterator[Any]:
    """Wrap a host batch iterator with a `size`-deep prefetch queue; each
    batch goes through `to_device_batch(batch, device)` in the producer
    thread."""
    device = torch.device(device)
    cuda = device.type == "cuda"
    copy_stream = torch.cuda.Stream(device) if cuda else None
    q: "queue.Queue" = queue.Queue(maxsize=size)
    done = object()
    stop = threading.Event()
    error: list = []

    def producer():
        try:
            for item in iterator:
                if cuda:
                    with torch.cuda.stream(copy_stream):
                        item = to_device_batch(item, device)
                        ready = torch.cuda.Event()
                        ready.record(copy_stream)
                    q.put((item, ready))
                else:
                    q.put((to_device_batch(item, device), None))
                if stop.is_set():
                    return
        except Exception as e:  # raised on the consumer's side
            error.append(e)
        finally:
            q.put(done)

    thread = threading.Thread(target=producer, daemon=True)
    thread.start()
    try:
        while True:
            got = q.get()
            if got is done:
                if error:
                    raise error[0]
                return
            item, ready = got
            if ready is not None:
                stream = torch.cuda.current_stream(device)
                stream.wait_event(ready)
                _record_stream(item, stream)
            yield item
    finally:
        # closed early (or done): let a producer blocked on a full queue
        # finish its put, see `stop` and end
        stop.set()
        while thread.is_alive():
            try:
                q.get(timeout=0.1)
            except queue.Empty:
                pass
