"""Training input pipeline over Lance-encoded storage.

Full-scan consumer of the paper's format: token documents are stored as a
mini-block-encoded ``List<int32>`` column; the loader scans chunks
sequentially, packs documents into fixed-length training sequences,
shuffles within a window, and prefetches batches on a background thread
(the scan overlaps the training step).

The deterministic cursor (seed, step) -> batch makes restarts resume
exactly.  The decode route comes from the file's footer: a token file
written with ``WriteOptions("lance", decode="device")`` (``write_table``
over :func:`synth.token_corpus`) scans its chunks
through the ``miniblock_decode`` kernel on the loader's ``device``; one
written with ``decode="numpy"`` decodes them on the host.  Either way the
batches are the same numpy int32 arrays.
"""

from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np

from ..core import arrays as A
from ..core.file import FileReader, WriteOptions, write_table
from . import synth

__all__ = ["write_token_file", "TokenLoader"]

# End-of-stream marker the producer enqueues on exit (normal stop or crash)
# so a blocked consumer always wakes instead of deadlocking on an empty
# queue whose producer is gone.
_SENTINEL = object()


def write_token_file(n_rows: int, seq_len: int, vocab: int, seed: int = 0,
                     encoding: str = "lance") -> bytes:
    corpus = synth.token_corpus(n_rows, seq_len, vocab, seed)
    return write_table({"tokens": corpus}, WriteOptions(encoding))


class TokenLoader:
    """Sequential-scan loader with shuffle window + prefetch.

    ``device`` is the reader's (CUDA unless the caller names the CPU; it
    raises here, before the producer starts, when CUDA is asked for and
    there is none)."""

    def __init__(self, file_bytes: bytes, *, batch: int, seq_len: int,
                 seed: int = 0, shuffle_window: int = 4096, prefetch: int = 2,
                 start_step: int = 0, device=None):
        self.reader = FileReader(file_bytes, device=device)
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        self.window = shuffle_window
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._done = False  # consumer-side latch: sentinel seen / stopped
        self._step = start_step
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()

    # -- deterministic token stream --------------------------------------
    def _token_stream(self) -> np.ndarray:
        arr = self.reader.scan("tokens")
        assert isinstance(arr, A.ListArray)
        return arr.child.values  # flattened token ids

    def _producer(self):
        try:
            flat = self._token_stream()
            per_batch = self.batch * (self.seq_len + 1)
            n_batches = len(flat) // per_batch
            rng = np.random.default_rng(self.seed)
            order = rng.permutation(n_batches)
            step = self._step
            while not self._stop.is_set():
                b = order[step % n_batches]
                chunk = flat[b * per_batch : (b + 1) * per_batch]
                toks = chunk.reshape(self.batch,
                                     self.seq_len + 1).astype(np.int32)
                try:
                    self._q.put((step, {"tokens": toks}), timeout=1.0)
                    step += 1
                except queue.Full:
                    continue
        finally:
            # Always leave a sentinel, whether we stopped cleanly or died
            # on an exception: a consumer blocked in __next__ must wake.
            # The producer owns the queue at this point, so if it is full
            # we discard a prefetched batch to make room — never block.
            while True:
                try:
                    self._q.put_nowait(_SENTINEL)
                    break
                except queue.Full:
                    try:
                        self._q.get_nowait()
                    except queue.Empty:
                        pass

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self):
        """Next prefetched batch; raises ``StopIteration`` (never hangs)
        once the producer has exited — clean stop, crash, or a ``stop()``
        that raced the last put."""
        while True:
            if self._done:
                raise StopIteration
            try:
                item = self._q.get(timeout=0.1)
            except queue.Empty:
                # no data: only keep waiting while the producer is alive
                # and nobody asked us to stop
                if self._stop.is_set() or not self._thread.is_alive():
                    self._done = True
                    raise StopIteration from None
                continue
            if item is _SENTINEL:
                self._done = True
                raise StopIteration
            _step, batch = item
            return batch

    def batch_for_step(self, step: int) -> Dict[str, np.ndarray]:
        """Pure (seed, step) -> batch mapping for exact restart resume."""
        flat = self._token_stream()
        per_batch = self.batch * (self.seq_len + 1)
        n_batches = len(flat) // per_batch
        rng = np.random.default_rng(self.seed)
        order = rng.permutation(n_batches)
        b = order[step % n_batches]
        chunk = flat[b * per_batch : (b + 1) * per_batch]
        return {"tokens": chunk.reshape(self.batch, self.seq_len + 1).astype(np.int32)}

    def stop(self):
        """Stop the producer and unblock any consumer: subsequent
        ``__next__`` calls raise ``StopIteration`` instead of deadlocking."""
        self._stop.set()
        self._thread.join(timeout=5.0)

    # historical name; same semantics
    close = stop
