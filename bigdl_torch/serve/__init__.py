"""Online serving: dynamic batching and the inference server."""

from .batcher import (DynamicBatcher, PendingRequest, RequestTimeout,
                      ServeError, ServerClosed, ServerOverloaded,
                      default_buckets, fit_bucket, pad_rows, pad_tail)
from .server import InferenceServer, ModelVersion

__all__ = ["InferenceServer", "ModelVersion", "DynamicBatcher",
           "PendingRequest", "ServeError", "ServerOverloaded",
           "ServerClosed", "RequestTimeout", "default_buckets",
           "fit_bucket", "pad_rows", "pad_tail"]
