"""Serving side of the port: QoS classes (copy of
``paddle_tpu/inference/qos.py``), the continuous-batching engine, the
HTTP server and client (`serving`), the replica `router` and
`autoscaler` (copies), and the replica `fleet`."""
from __future__ import annotations
