"""Remote optimization client with graceful local fallback.

Async TCP client speaking the framed graph protocol (``io/codec.py``)
against either the native server (``io/native.py``) or the pure-Python one
(``io/server.py``): connect, write the graph, await the framed answer.

:func:`optimize_with_fallback` tries the remote backend and runs the
in-process optimizer when the connection fails.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

from toyslam_torch.io import codec
from toyslam_torch.models.graph import FactorGraph2D


class GraphClient:
    """``await connect() -> await optimize(graph) -> close()``."""

    def __init__(self, host: str = "127.0.0.1", port: int = 8888):
        self.host = host
        self.port = port
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None

    async def connect(self, timeout: float = 5.0) -> None:
        self._reader, self._writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), timeout
        )

    @property
    def connected(self) -> bool:
        return self._writer is not None

    async def optimize(
        self, graph: FactorGraph2D, timeout: float = 120.0
    ) -> FactorGraph2D:
        """Ship the graph, await the optimized graph (CPU tensors)."""
        if not self.connected:
            raise ConnectionError("not connected")
        self._writer.write(codec.graph_to_bytes(graph))
        await self._writer.drain()

        head = await asyncio.wait_for(self._reader.readexactly(4), timeout)
        (size,) = struct.unpack("<I", head)
        body = await asyncio.wait_for(
            self._reader.readexactly(size), timeout
        )
        return codec.bytes_to_graph(head + body)

    async def close(self) -> None:
        if self._writer is not None:
            self._writer.close()
            try:
                await self._writer.wait_closed()
            except (ConnectionError, OSError):
                pass
            self._writer = None
            self._reader = None


async def optimize_with_fallback(
    graph: FactorGraph2D,
    client: Optional[GraphClient],
    local_optimize,
) -> tuple[FactorGraph2D, str]:
    """Remote optimize; on any transport failure run ``local_optimize``.

    Returns ``(optimized_graph, backend)`` with backend "remote" or "local".
    """
    if client is not None:
        try:
            if not client.connected:
                await client.connect()
            return await client.optimize(graph), "remote"
        except (ConnectionError, OSError, asyncio.TimeoutError,
                asyncio.IncompleteReadError):
            await client.close()
    return local_optimize(graph), "local"
