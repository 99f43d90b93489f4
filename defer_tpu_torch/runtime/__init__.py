"""Host-side runtime of the stream loop: sentinel, watchdog, batching."""
