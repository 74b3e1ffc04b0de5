"""One host worker thread, for work that runs beside tracking: the
deferred local BA, loop detection with its Sim3 chain, and the
asynchronous global BA (the reference's LocalMapping, LoopClosing and
global-BA threads).  The JAX package gets this asynchrony from JAX's
asynchronous dispatch and a plain ``threading.Thread``; the port's
solvers synchronise with the host inside their loops, so a deferred solve
runs on a thread of its own.

The thread is a one-thread ``ThreadPoolExecutor``: jobs run in the order
they were submitted, and an exception raised by a job is stored in its
future and raised again where the future's result is read.  Device work
of a job runs on the worker's own CUDA stream, which first waits for
everything the submitting thread had queued on its current stream (so
device tensors made before the submit, such as the vocabulary's tree,
are complete when the job reads them).  Jobs take numpy inputs packed on
the submitting thread and return host results: no device tensor is
written by one thread while another reads it, and no caching-allocator
block of one stream is reused under the other.  A job that must hand a
device tensor across threads calls ``record_stream`` on it.
"""

from __future__ import annotations

import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor, wait

import torch

# torch's forward-mode AD levels are process-wide, not per thread: two
# threads inside torch.func.jacfwd at once invalidate each other's levels
# ("Trying to access a forward AD level with an invalid index").  Every
# jacfwd of the package (Sim3 refinement on a loop-closing worker, the
# pose graph at a correction) holds this lock; B sequences' workers and
# the multi-sequence consume pool run them side by side.
FORWARD_AD_LOCK = threading.Lock()


class Worker:
    """One thread, named ``<name>_0``, that runs submitted jobs in order;
    ``busy_s`` is the time it has spent in them."""

    def __init__(self, name: str, device):
        self.name = name
        self.device = torch.device(device)
        self.busy_s = 0.0
        self._stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        self._pool = ThreadPoolExecutor(max_workers=1, thread_name_prefix=name)
        self._last: Future | None = None
        self._stopped = False

    def submit(self, fn, *args) -> Future:
        """Queue fn(*args); its future holds the result or the exception."""
        if self._stopped:
            raise RuntimeError(f"worker {self.name!r} was stopped")
        ready = None
        if self._stream is not None:
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
        self._last = self._pool.submit(self._run, fn, args, ready)
        return self._last

    def _run(self, fn, args, ready):
        t0 = time.perf_counter()
        try:
            if self._stream is None:
                return fn(*args)
            with torch.cuda.stream(self._stream):
                self._stream.wait_event(ready)
                return fn(*args)
        finally:
            self.busy_s += time.perf_counter() - t0

    def join(self):
        """Wait until every job submitted so far has finished."""
        if self._last is not None:
            wait([self._last])

    def is_alive(self) -> bool:
        """True until ``stop``: the worker takes jobs."""
        return not self._stopped

    def stop(self):
        """Finish the queued jobs, then end the thread and join it."""
        self._stopped = True
        self._pool.shutdown(wait=True)
