"""Core helpers of the port: default-device resolution and env knobs."""
from __future__ import annotations

from .device import resolve_device  # noqa: F401
from .flags import _env_num  # noqa: F401
