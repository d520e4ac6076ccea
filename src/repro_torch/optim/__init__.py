"""The optimizer of the port: AdamW and global-norm clipping."""
