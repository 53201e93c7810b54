"""Host-side training-batch preparation."""
