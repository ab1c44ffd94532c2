"""Serving substrate: prefill and decode steps over a KV cache."""
