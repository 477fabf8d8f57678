"""Host DAG task pipeline with per-stage multiple buffering.

A copy of ``nvbio_tpu.utils.pipeline`` (host code, no device work).
Counterpart of the reference's ``nvbio/basic/pipeline.h:58-93``
(``Pipeline`` with ``append_stage``/``append_sink``/``run``) and
``threads.h`` WorkQueues: stages form a chain, each running on its own
thread, connected by bounded queues whose depth is the stage's buffer count
— so a slow consumer back-pressures the producer exactly like the
reference's ring of reusable buffers. nvLighter-style multi-phase jobs
(sample -> mark -> correct) and the map CLI's parse/compute/format overlap
are the intended users.
"""

from __future__ import annotations

import queue
import threading

_DONE = object()


class PipelineStage:
    """Base class: override ``process(item) -> item_out`` (or ``source()``
    yielding items for the head stage)."""

    def process(self, item):
        raise NotImplementedError

    def source(self):
        raise NotImplementedError


class Pipeline:
    def __init__(self):
        self._stages: list[tuple[PipelineStage, int]] = []

    def append_stage(self, stage: PipelineStage, buffers: int = 2) -> None:
        self._stages.append((stage, max(1, buffers)))

    # reference naming: the last stage is the sink
    append_sink = append_stage

    def run(self):
        """Run all stages to completion; returns the sink's outputs list.

        The head stage must implement ``source()``; the others ``process``.
        Exceptions in any stage propagate to the caller.
        """
        if not self._stages:
            return []
        qs = [queue.Queue(maxsize=b) for _, b in self._stages[1:]]
        errors: list[BaseException] = []
        abort = threading.Event()
        results: list = []

        def put_or_abort(q, item) -> bool:
            while not abort.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def head():
            stage = self._stages[0][0]
            try:
                for item in stage.source():
                    if qs:
                        if not put_or_abort(qs[0], item):
                            break
                    else:
                        results.append(item)
            except BaseException as e:  # noqa: BLE001 — relayed to caller
                errors.append(e)
                abort.set()
            finally:
                if qs:
                    put_or_abort(qs[0], _DONE) or qs[0].put(_DONE)

        def worker(i):
            stage = self._stages[i][0]
            q_in = qs[i - 1]
            q_out = qs[i] if i < len(qs) else None
            try:
                while True:
                    try:
                        item = q_in.get(timeout=0.1)
                    except queue.Empty:
                        if abort.is_set():
                            break
                        continue
                    if item is _DONE:
                        break
                    out = stage.process(item)
                    if q_out is not None:
                        if not put_or_abort(q_out, out):
                            break
                    else:
                        results.append(out)
            except BaseException as e:  # noqa: BLE001
                errors.append(e)
                abort.set()
            finally:
                # unblock the upstream producer, then signal downstream
                if abort.is_set():
                    while True:
                        try:
                            q_in.get_nowait()
                        except queue.Empty:
                            break
                if q_out is not None:
                    put_or_abort(q_out, _DONE) or q_out.put(_DONE)

        threads = [threading.Thread(target=head)]
        threads += [threading.Thread(target=worker, args=(i,))
                    for i in range(1, len(self._stages))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise errors[0]
        return results
