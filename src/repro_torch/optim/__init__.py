"""AdamW for the port's training step."""
