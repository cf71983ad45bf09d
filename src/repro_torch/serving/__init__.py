"""Serving the generator as a causal LM: the continuous-batching engine,
its paged caches and its front end (port of `repro.serving`)."""
from repro_torch.serving.engine import ServingEngine, Request
from repro_torch.serving.frontend import ServingFrontend
from repro_torch.serving import cache
