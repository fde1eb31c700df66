"""Inference engine: KV caches, prefill and decode."""

from .engine import InferenceEngine  # noqa: F401
from .kvcache import make_caches  # noqa: F401
