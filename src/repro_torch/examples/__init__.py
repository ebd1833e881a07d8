"""Runnable examples of the port (the counterparts of the reference's
``examples/``): ``python -m repro_torch.examples.quickstart``,
``.serve_llm`` and ``.collectives_demo``, on the card unless given
``--device cpu``."""
