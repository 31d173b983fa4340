"""TCPStore (``paddle_tpu/distributed/store.py`` counterpart): the
rendezvous key-value store of the fleet's heartbeat plane, over
`torch.distributed.TCPStore` instead of the JAX package's native C++
server.

The methods and their conventions are the JAX store's:

  * `set(key, value)` takes str or bytes (str is UTF-8 encoded);
  * `get(key, timeout=None)` returns bytes; it waits for the key first
    (polling `check`) and raises TimeoutError after `timeout` seconds
    (the store's `timeout` when None), as the JAX store does, instead of
    torch's own blocking get with its error type;
  * `add(key, amount)` returns the new int value;
  * `check(key)` is a non-blocking bool for one key;
  * `wait(keys, timeout=None)` polls every key and raises TimeoutError
    naming the first missing one;
  * `barrier` is the JAX store's reusable barrier, its round derived
    from one global arrival counter.

The master binds `port` on `host`; failing to bind raises OSError, and
a client that cannot reach the master within `timeout` raises
ConnectionError, so a caller probing for a free port catches either.
`set`, `get` and `add` raise ConnectionError when the store fails them,
as the JAX store does (torch's own error is a RuntimeError); so does
`check`, where the JAX store's native call reads a lost connection as a
present key.
"""
from __future__ import annotations

import datetime
import time

import torch.distributed as dist


class TCPStore:
    def __init__(self, host="127.0.0.1", port=8577, is_master=False,
                 world_size=1, timeout=120.0):
        self.host = host
        self.port = port
        self.world_size = world_size
        self.timeout = timeout
        try:
            self._store = dist.TCPStore(
                host, int(port), is_master=bool(is_master),
                timeout=datetime.timedelta(seconds=float(timeout)),
                wait_for_workers=False)
        except RuntimeError as e:
            if is_master:
                raise OSError(f"TCPStore server failed to bind :{port}: "
                              f"{e}") from e
            raise ConnectionError(f"TCPStore connect to {host}:{port} "
                                  f"failed: {e}") from e

    def set(self, key, value):
        if isinstance(value, str):
            value = value.encode()
        try:
            self._store.set(key, value)
            # torch's set is not answered: a round trip makes a lost
            # master fail this call, as the JAX store's answered set does
            self._store.check([key])
        except RuntimeError as e:
            raise ConnectionError(f"TCPStore set failed: {e}") from e

    def get(self, key, timeout=None):
        # torch's get blocks for the store's whole timeout; apply this
        # call's deadline by polling check first, then the (now
        # immediate) get
        self.wait([key], timeout=timeout)
        try:
            return bytes(self._store.get(key))
        except RuntimeError as e:
            raise ConnectionError(f"TCPStore get({key!r}) failed: "
                                  f"{e}") from e

    def add(self, key, amount):
        try:
            return int(self._store.add(key, int(amount)))
        except RuntimeError as e:
            raise ConnectionError(f"TCPStore add failed: {e}") from e

    def check(self, key):
        try:
            return bool(self._store.check([key]))
        except RuntimeError as e:
            raise ConnectionError(f"TCPStore check({key!r}) failed: "
                                  f"{e}") from e

    def wait(self, keys, timeout=None):
        deadline = time.time() + (timeout or self.timeout)
        for k in keys if isinstance(keys, (list, tuple)) else [keys]:
            while not self.check(k):
                if time.time() > deadline:
                    raise TimeoutError(f"TCPStore wait timeout on {k!r}")
                time.sleep(0.05)

    def barrier(self, key="_barrier", world_size=None):
        # reusable barrier with the round derived from one global
        # arrival counter: a caller's position in the arrival order
        # fixes its round, so a relaunched rank continues at the
        # cluster's current round instead of restarting at 0
        n = world_size or self.world_size
        seq = self.add(f"{key}/seq", 1)
        r = (seq - 1) // n
        if seq == (r + 1) * n:
            self.set(f"{key}/go/{r}", b"1")
        self.wait([f"{key}/go/{r}"])
