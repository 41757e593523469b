"""AdamW, train and serve steps, and the fault-tolerant training loop."""
