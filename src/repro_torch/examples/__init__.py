"""The JAX package's query examples (``examples/quickstart.py``,
``examples/wikidata_style_queries.py``) as the port's entry points, run
as ``python -m repro_torch.examples.<name>``: on the card by default, on
the host with ``--device cpu``."""
