"""Logging, device completion, tracing and the kernel build helper."""
