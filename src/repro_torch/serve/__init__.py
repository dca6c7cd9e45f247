"""Serving runtime of the port: ``engine`` holds the batched LM decode
with KV caches or recurrent state and its continuous-batching scheduler."""
