"""The LM substrate's dense family: layers, the transformer, losses, API."""
