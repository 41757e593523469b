"""The LM substrate: layers, the models of every family, losses, API."""
