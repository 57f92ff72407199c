"""Streaming ingestion: host→device feeding overlapped with device sweeps.

The reference ingests data by ``set_value!`` on observation signals followed
by ``update_marginals!`` (``test/inference_engine_tests.jl:348-351,469-472``)
— synchronous and single-threaded.  The accelerator pattern: keep the filtering
posterior on device as carried state, and exploit JAX's asynchronous dispatch
to overlap the host transfer of chunk *i+1* with the device computation of
chunk *i* (double buffering): ``device_put`` of the next chunk is enqueued
before blocking on the current chunk's result.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Optional, Tuple

import jax

__all__ = ["stream_filter", "StreamingSession"]


def stream_filter(
    chunk_step: Callable[[Any, jax.Array], Tuple[Any, Any]],
    chunks: Iterable[Any],
    init_state: Any,
    device: Optional[jax.Device] = None,
) -> Tuple[Any, list]:
    """Run ``state, out = chunk_step(state, chunk)`` over a chunk stream with
    one chunk of host→device transfer always in flight.

    ``chunk_step`` should be jitted; outputs are collected per chunk (device
    arrays — convert at the end to avoid synchronizing the pipeline).
    """
    it = iter(chunks)
    outputs = []
    state = init_state

    try:
        current = jax.device_put(next(it), device)
    except StopIteration:
        return state, outputs

    while True:
        # Enqueue next transfer before dispatching compute on the current
        # chunk, so the copy overlaps the device work.
        nxt = next(it, None)
        if nxt is not None:
            nxt = jax.device_put(nxt, device)
        state, out = chunk_step(state, current)
        outputs.append(out)
        if nxt is None:
            break
        current = nxt

    return state, outputs


class StreamingSession:
    """Stateful streaming inference: push chunks, read the running posterior.

    The online analogue of the reference's repeated ``set_value!`` /
    ``update_marginals!`` loop, with the posterior carried on device.

    Example::

        session = StreamingSession(jax.jit(model_chunk_step), model.init_state())
        for chunk in source:
            session.push(chunk)
        posterior = session.state
    """

    def __init__(
        self,
        chunk_step: Callable[[Any, jax.Array], Tuple[Any, Any]],
        init_state: Any,
        device: Optional[jax.Device] = None,
    ) -> None:
        self._step = chunk_step
        self.state = init_state
        self._device = device
        self._pending: Optional[jax.Array] = None
        self.outputs: list = []

    def push(self, chunk) -> None:
        """Enqueue a chunk; compute is dispatched asynchronously."""
        staged = jax.device_put(chunk, self._device)
        if self._pending is not None:
            self.state, out = self._step(self.state, self._pending)
            self.outputs.append(out)
        self._pending = staged

    def flush(self) -> Any:
        """Process any staged chunk and block until the posterior is ready."""
        if self._pending is not None:
            self.state, out = self._step(self.state, self._pending)
            self.outputs.append(out)
            self._pending = None
        jax.block_until_ready(self.state)
        return self.state
