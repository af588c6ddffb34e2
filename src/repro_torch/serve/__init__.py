"""Serving runtime (the port of ``repro.serve``): static and continuous
batching over device-resident KV caches."""
