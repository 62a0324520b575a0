"""Serving of the port: the engine, its device functions, the paged KV cache."""
