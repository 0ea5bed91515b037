"""Host-to-device prefetch of the host loader's batches.

Counterpart of ``optimalstrategiesagainstgenerativeattacks_tpu/data/prefetch.py``.
A producer thread assembles the next ``depth`` batches, pins each array and
copies it to the card on a side stream (``non_blocking``), then records an
event; the consumer makes its current stream wait on that event before it
yields the batch, and marks each tensor as used by that stream
(``record_stream``), so the caching allocator does not hand the memory to the
side stream's next copy while the step still reads it.  The batch assembly
and the copy overlap the previous step.  Batches stay uint8 until the train
step normalises them.  In a data-parallel run each rank copies its shard to
its own card: the loop passes the rank's device, and a bare "cuda" means
the current card, which ``parallel/mesh.py:init_process`` sets first.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import torch

_DONE = object()


def _to_tensors(batch) -> Dict[str, torch.Tensor]:
    # contiguous: a batched gather yields strided views, and a pinned buffer should be dense
    return {k: torch.as_tensor(v).contiguous() for k, v in batch.items()}


def device_prefetch(iterator: Iterator, device, depth: int = 2) -> Iterator[Dict[str, torch.Tensor]]:
    """Yield the batches of ``iterator`` (dicts of numpy arrays) as tensors on ``device``.

    ``depth <= 0`` copies each batch synchronously in the caller's thread.
    Otherwise a thread runs up to ``depth`` batches ahead; on a CPU device it
    only wraps the arrays, in order.  An error of the producer is raised in
    the consumer; closing the generator (a ``break`` out of an epoch, an
    interrupt) stops the thread and waits for it.
    """
    device = torch.device(device)
    on_card = device.type == "cuda"
    if depth <= 0:
        for batch in iterator:
            yield {k: v.to(device) for k, v in _to_tensors(batch).items()}
        return

    if on_card:
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = torch.cuda.Stream(device)

    def stage(batch):
        tensors = _to_tensors(batch)
        if not on_card:
            return tensors, None
        with torch.cuda.stream(stream):
            out = {k: v.pin_memory().to(device, non_blocking=True) for k, v in tensors.items()}
            event = torch.cuda.Event()
            event.record(stream)
        return out, event

    q: "queue.Queue" = queue.Queue(maxsize=depth)
    stop = threading.Event()
    err = []

    def put(item) -> bool:
        """Queue ``item`` unless the consumer stopped; False once it has."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def producer():
        if on_card:
            torch.cuda.set_device(device)
        try:
            for batch in iterator:
                if not put(stage(batch)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            err.append(e)
        finally:
            put(_DONE)

    thread = threading.Thread(target=producer, name="device_prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is _DONE:
                if err:
                    raise err[0]
                return
            tensors, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                for v in tensors.values():
                    v.record_stream(current)
            yield tensors
    finally:
        stop.set()
        thread.join()

