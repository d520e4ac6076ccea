"""Host data pipeline of the port (numpy; the trainer moves batches to
the device)."""
