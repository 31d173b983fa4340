"""Serving side of the port: QoS classes (copy of
``paddle_tpu/inference/qos.py``) and the continuous-batching engine."""
from __future__ import annotations
